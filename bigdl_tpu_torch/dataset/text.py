"""Text data for the language-model path.

Ports `synthetic_next_token` from bigdl_tpu/dataset/text.py (the
dictionary and tokenizer pipeline of that file is queued, ROADMAP.md).
"""

from __future__ import annotations

from typing import List

import numpy as np

from bigdl_tpu_torch.dataset.sample import Sample


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
