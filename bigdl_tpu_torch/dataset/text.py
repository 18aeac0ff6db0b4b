"""Text pipeline for the language-model path.

Ports bigdl_tpu/dataset/text.py (reference: dataset/text/ —
`Dictionary`, `SentenceTokenizer`, `SentenceBiPadding` with its
SENTENCESTART/SENTENCEEND markers, `TextToLabeledSentence`,
`LabeledSentenceToSample`; the PTB language model of models/rnn/ and
example/languagemodel), with the same tokenizer regex and the same
tie order in `Dictionary`'s `most_common`, so both packages turn the
same text into the same ids; and `synthetic_next_token`.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample
from bigdl_tpu_torch.dataset.transformer import Transformer

SENTENCE_START = "SENTENCESTART"
SENTENCE_END = "SENTENCEEND"


class Dictionary:
    """Word ↔ index vocabulary (reference: dataset/text/Dictionary.scala).

    Keeps the `vocab_size` most frequent words; everything else maps to the
    unknown token (index = vocab_size, i.e. last).
    """

    def __init__(self, sentences: Optional[Sequence[Sequence[str]]] = None,
                 vocab_size: Optional[int] = None):
        self.word2index: Dict[str, int] = {}
        self.index2word: List[str] = []
        if sentences is not None:
            counts = Counter(w for s in sentences for w in s)
            if vocab_size is not None:
                common = counts.most_common(vocab_size)
            else:
                common = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            for w, _ in common:
                self.add_word(w)

    @property
    def unk_index(self) -> int:
        """Index of the unknown-word bucket — always one past the known
        words, so it stays valid after later add_word() calls."""
        return len(self.index2word)

    def add_word(self, word: str) -> int:
        if word not in self.word2index:
            self.word2index[word] = len(self.index2word)
            self.index2word.append(word)
        return self.word2index[word]

    def index(self, word: str) -> int:
        return self.word2index.get(word, self.unk_index)

    def vocab_size(self) -> int:
        """Vocabulary size INCLUDING the unk bucket."""
        return len(self.index2word) + 1

    def __len__(self):
        return len(self.index2word)


class SentenceTokenizer(Transformer):
    """Lowercase word tokenizer (reference: dataset/text/SentenceTokenizer.scala)."""

    PATTERN = re.compile(r"[A-Za-z']+|[0-9]+|[^\sA-Za-z0-9]")

    def apply(self, it):
        for text in it:
            yield self.PATTERN.findall(text.lower())


class SentenceBiPadding(Transformer):
    """Wrap sentences with start/end markers
    (reference: dataset/text/SentenceBiPadding.scala)."""

    def apply(self, it):
        for words in it:
            yield [SENTENCE_START] + list(words) + [SENTENCE_END]


class TextToLabeledSentence(Transformer):
    """words → (input ids, next-word label ids) for LM training
    (reference: dataset/text/TextToLabeledSentence.scala)."""

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def apply(self, it):
        for words in it:
            ids = np.asarray([self.dictionary.index(w) for w in words], np.int32)
            yield (ids[:-1], ids[1:])


class LabeledSentenceToSample(Transformer):
    """(data ids, label ids) → fixed-length Sample
    (reference: dataset/text/LabeledSentenceToSample.scala).

    Pads/truncates to `fixed_length`, so every Sample has one shape;
    padded label positions get `pad_label` (mask in the criterion).
    """

    def __init__(self, fixed_length: int, pad_data: int = 0, pad_label: int = 0):
        self.fixed_length = fixed_length
        self.pad_data = pad_data
        self.pad_label = pad_label

    def _fix(self, ids, pad):
        out = np.full((self.fixed_length,), pad, np.int32)
        n = min(len(ids), self.fixed_length)
        out[:n] = ids[:n]
        return out

    def apply(self, it):
        for data, label in it:
            yield Sample(self._fix(data, self.pad_data),
                         self._fix(label, self.pad_label))


def synthetic_next_token(n: int, vocab: int, seq: int,
                         seed: int = 0) -> List[Sample]:
    """Synthetic next-token LM Samples on a cyclic grammar: each
    sequence is (start + arange) % vocab, the target is the input
    shifted by one — the same arrays as the JAX package's for the same
    arguments (reference: example/languagemodel synthetic mode)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        start = rng.randint(0, vocab)
        s = (start + np.arange(seq + 1)) % vocab
        out.append(Sample(s[:-1].astype(np.int32), s[1:].astype(np.int32)))
    return out
