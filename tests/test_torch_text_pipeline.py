"""The port's text pipeline (bigdl_tpu_torch/dataset/text.py) against
the JAX package's (bigdl_tpu/dataset/text.py): `Dictionary` (words,
indices, the unknown bucket, `vocab_size`, frequency ties), the
tokenizer and the PTB-style LM pipeline `SentenceTokenizer >>
SentenceBiPadding >> TextToLabeledSentence >> LabeledSentenceToSample`
on a seeded corpus, and the next-word property of its samples.

Tolerance: none — both packages run the same regex and the same numpy,
so ids, samples and batches are equal bit for bit.
"""

import numpy as np
import pytest

from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.dataset import text as jtext
from bigdl_tpu.dataset.transformer import SampleToMiniBatch as JBatch
from bigdl_tpu_torch.dataset import DataSet as TDataSet
from bigdl_tpu_torch.dataset import text as ttext
from bigdl_tpu_torch.dataset.transformer import SampleToMiniBatch as TBatch

SEQ, BATCH = 12, 4


def _corpus(n, n_words=60, seed=0):
    """n sentences of 3-16 words drawn with Zipf frequencies from
    n_words lowercase words, with capitals, digits, apostrophes and
    punctuation for the tokenizer."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, rng.randint(2, 8)))
             for _ in range(n_words)]
    words[3], words[7] = "don't", "42"
    p = 1.0 / np.arange(1, n_words + 1)
    p /= p.sum()
    out = []
    for _ in range(n):
        ws = [words[i] for i in rng.choice(n_words, rng.randint(3, 17), p=p)]
        ws[0] = ws[0].capitalize()
        out.append(" ".join(ws) + rng.choice([".", "!", " ?", ", ok."]))
    return out


def _pipeline(text_mod, dictionary):
    return (text_mod.SentenceTokenizer() >> text_mod.SentenceBiPadding()
            >> text_mod.TextToLabeledSentence(dictionary)
            >> text_mod.LabeledSentenceToSample(SEQ))


def _tokenized(text_mod, texts):
    return list((text_mod.SentenceTokenizer()
                 >> text_mod.SentenceBiPadding())(texts))


@pytest.mark.parametrize("vocab_size", [None, 5, 20])
def test_dictionary_matches_jax(vocab_size):
    texts = _corpus(50)
    jd = jtext.Dictionary(_tokenized(jtext, texts), vocab_size=vocab_size)
    td = ttext.Dictionary(_tokenized(ttext, texts), vocab_size=vocab_size)
    assert td.index2word == jd.index2word
    assert td.word2index == jd.word2index
    assert td.unk_index == jd.unk_index == len(td)
    assert td.vocab_size() == jd.vocab_size() == len(td) + 1
    if vocab_size is not None:
        assert len(td) == vocab_size
    for w in ("SENTENCESTART", "never-seen", "don't", "42"):
        assert td.index(w) == jd.index(w)
    assert td.index("never-seen") == td.unk_index
    assert td.add_word("fresh") == jd.add_word("fresh") == td.unk_index - 1


def test_dictionary_keeps_counters_tie_order():
    sents = [["b", "a", "c"], ["a", "b", "d"]]   # a, b: 2; c, d: 1
    for mod in (jtext, ttext):
        assert mod.Dictionary(sents, vocab_size=3).index2word == \
            ["b", "a", "c"]                      # ties by first sight
        assert mod.Dictionary(sents).index2word == ["a", "b", "c", "d"]


def test_tokenizer_matches_jax():
    texts = ["Don't stop: 3 cats, 14 dogs!", "  Tabs\tand  spaces ", ""]
    assert list(ttext.SentenceTokenizer()(texts)) == \
        list(jtext.SentenceTokenizer()(texts))
    assert list(ttext.SentenceTokenizer()(texts[:1]))[0] == \
        ["don't", "stop", ":", "3", "cats", ",", "14", "dogs", "!"]


def test_lm_pipeline_matches_jax_bit_for_bit():
    texts = _corpus(30, seed=1)
    out = {}
    for key, mod, ds, batch in (("jax", jtext, JDataSet, JBatch),
                                ("torch", ttext, TDataSet, TBatch)):
        d = mod.Dictionary(_tokenized(mod, texts), vocab_size=25)
        data = ds.array(texts, seed=4) >> _pipeline(mod, d) >> batch(BATCH)
        it = data.data(train=True)
        out[key] = ([next(it) for _ in range(20)],
                    list(data.data(train=False)))
    for jb, tb in zip(out["jax"][0] + out["jax"][1],
                      out["torch"][0] + out["torch"][1]):
        for a, b in ((tb.input, jb.input), (tb.target, jb.target)):
            assert a.dtype == np.int32 and a.shape == (BATCH, SEQ)
            np.testing.assert_array_equal(a, b)
        assert tb.real_size == jb.real_size
    assert len(out["torch"][1]) == 8 and out["torch"][1][-1].real_size == 2


def test_samples_predict_the_next_word():
    texts = _corpus(20, seed=2)
    tokens = _tokenized(ttext, texts)
    d = ttext.Dictionary(tokens)
    samples = list(_pipeline(ttext, d)(texts))
    assert len(samples) == len(texts)
    for words, s in zip(tokens, samples):
        ids = [d.index(w) for w in words]
        n = min(len(ids) - 1, SEQ)
        np.testing.assert_array_equal(s.feature[:n], ids[:n])
        np.testing.assert_array_equal(s.label[:n], ids[1:n + 1])
        # the label is the input shifted by one word
        np.testing.assert_array_equal(s.label[:n - 1], s.feature[1:n])
        assert (s.feature[n:] == 0).all() and (s.label[n:] == 0).all()
        assert s.feature[0] == d.index("SENTENCESTART")
        if len(ids) - 1 <= SEQ:
            assert s.label[n - 1] == d.index("SENTENCEEND")


def test_synthetic_next_token_matches_jax():
    for a, b in zip(ttext.synthetic_next_token(5, 11, 7, seed=3),
                    jtext.synthetic_next_token(5, 11, 7, seed=3)):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.label, b.label)
