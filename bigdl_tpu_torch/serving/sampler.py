"""Token sampling — greedy / temperature / top-k / top-p (nucleus).

Ports bigdl_tpu/serving/sampler.py. Every knob is a per-ROW tensor, so
one decode step serves requests with different sampling settings.
Conventions: temperature <= 0 → greedy (argmax, knobs ignored);
top_k <= 0 → top-k off; top_p >= 1 → nucleus off. Filters compose the
standard way: top-k first, then top-p over the survivors with the top-1
always kept, then a categorical draw by Gumbel-max.

Noise: each sampled row draws from its own `torch.Generator`, seeded
from (request seed, number of tokens generated so far) by
`row_generator`. A request's tokens therefore depend on its seed alone,
never on its slot or its co-batch. The bits differ from the JAX
package's threefry keys, so sampled tokens agree with the JAX engine
in distribution only; greedy tokens agree exactly.

Every op is per row: a NaN/inf logits row yields a garbage token for
that row only, which the engine discards (utils/anomaly.rows_finite).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_NEG_INF = -1e30
_MASK64 = (1 << 64) - 1


def row_generator(seed: int, n_generated: int,
                  device: torch.device) -> torch.Generator:
    """The generator a row samples its `n_generated`-th token with: a
    splitmix64 mix of (seed, n_generated), so neighbouring seeds and
    counts start far apart in the generator's stream."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(n_generated) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    z ^= z >> 31
    g = torch.Generator(device=device)
    g.manual_seed(z & ((1 << 63) - 1))
    return g


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor
                  ) -> torch.Tensor:
    """Temperature-scale then mask logits (B, V) to the top-k / top-p
    support per row; masked entries at -1e30. One sort: the descending
    probabilities for the top-p prefix come from the softmax of the
    sorted logits, and the cut-off goes back to the unsorted row as a
    LOGIT threshold (an exact comparison against copies of the same
    values)."""
    v = logits.shape[-1]
    lt = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    top_k = top_k.long()
    desc = torch.sort(lt, dim=-1, descending=True).values       # (B, V)
    kth = desc.gather(-1, (top_k - 1).clamp(0, v - 1)[:, None])  # (B, 1)
    k_off = (top_k <= 0)[:, None]
    keep_k = k_off | (lt >= kth)
    desc_keep = k_off | (desc >= kth)
    sp = torch.where(desc_keep, torch.softmax(
        torch.where(desc_keep, desc, _NEG_INF), dim=-1), 0.0)
    csum = sp.cumsum(dim=-1)
    first = torch.arange(v, device=logits.device)[None, :] == 0
    keep_sorted = ((csum - sp) < top_p.float()[:, None]) | first
    thr = torch.where(keep_sorted & desc_keep, desc,
                      float("inf")).amin(dim=-1)
    return torch.where(keep_k & (lt >= thr[:, None]), lt, _NEG_INF)


def sample_logits(logits: torch.Tensor,
                  generators: Sequence[Optional[torch.Generator]],
                  temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Next-token ids (B,) int32. `generators[i]` is row i's generator
    (`row_generator`), or None for a greedy row. When every row is
    greedy only the argmax runs — decided on the host from
    `generators`, so the step needs no device sync for it."""
    greedy = logits.argmax(dim=-1)
    if all(g is None for g in generators):
        return greedy.to(torch.int32)
    b, v = logits.shape
    filt = filter_logits(logits, temperature, top_k, top_p)
    # greedy rows keep a placeholder draw; their argmax wins below
    u = torch.full((b, v), 0.5, device=logits.device)
    for i, g in enumerate(generators):
        if g is not None:
            u[i] = torch.rand(v, generator=g, device=logits.device)
    # uniform in [1e-20, 1), as the JAX package draws it
    gumbel = -torch.log(-torch.log(u + 1e-20))
    sampled = (filt + gumbel).argmax(dim=-1)
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)
