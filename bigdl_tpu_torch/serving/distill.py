"""Online draft distillation: the training half of the speculation
flywheel.

Ports `DraftDistiller` from bigdl_tpu/serving/distill.py. The accept
rate of a `SpeculativeEngine` is how well the draft predicts the
target's next sample on the traffic being served, so the fleet's own
emitted streams are the distillation corpus: every result the target
produced is, verbatim, (context -> next token) supervision for the
draft.

    distiller = DraftDistiller(draft_model)
    for res in results:
        distiller.ingest(res)            # prompt + emitted tokens
    spec.swap_draft(distiller.distill())

`distill()` trains from the draft's current weights (a warm start: the
flywheel accumulates) through the port's `Optimizer(...).set_mesh(mesh,
zero=2)`, i.e. parallel/distri_optimizer.DistriOptimizer with ZeRO-2,
on a one-rank mesh by default (parallel/mesh.make_mesh({"data": 1}) on
the draft's device: NCCL on the card, gloo on the CPU), and returns a
fresh variables tree for `SpeculativeEngine.swap_draft` /
`InferenceEngine.swap_params`. On the card the draft's training step
runs the flash kernels (K2-K5), and its serving runs the paged-decode
kernel (K1). The serving side never sees the training: it runs on
copies of the draft's variables, the returned tree shares no storage
with the serving layout, and on failure the model's variables are
restored. Tokens cannot move either way: acceptance is coupled sampling
(serving/speculative.py), so a better draft raises only the accept
rate.

Determinism: ingestion order is the sample order, the Optimizer seed is
a constructor argument, and the port's training step is deterministic
on one device, so two distills over the same streams from the same
weights return bitwise-equal variables.

Every knob is a constructor argument, never the environment.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, List

import numpy as np

__all__ = ["DraftDistiller"]


class DraftDistiller:
    """Accumulate served token streams; train an improved draft.

    `model` is the draft's model object (a built `TransformerLM`, whose
    `variables` the draft engine was made from); its `cfg.max_len` must
    cover `seq_len`. Streams shorter than seq_len+1 tokens are skipped:
    every window has one shape."""

    def __init__(self, model, *, seq_len: int = 16, batch_size: int = 32,
                 learningrate: float = 3e-3, epochs: int = 2,
                 zero: int = 2, mesh=None, max_streams: int = 1024,
                 seed: int = 0):
        if seq_len < 1:
            raise ValueError("seq_len must be >= 1")
        max_len = getattr(getattr(model, "cfg", None), "max_len", None)
        if max_len is not None and seq_len > max_len:
            raise ValueError(f"seq_len {seq_len} exceeds the draft's "
                             f"max_len {max_len}")
        if epochs < 1:
            raise ValueError("epochs must be >= 1")
        if zero not in (1, 2):
            raise ValueError(f"zero must be 1 or 2, got {zero!r}")
        self._model = model
        self.seq_len = int(seq_len)
        self.batch_size = int(batch_size)
        self.learningrate = float(learningrate)
        self.epochs = int(epochs)
        self.zero = int(zero)
        self.mesh = mesh
        self.seed = int(seed)
        # newest-wins corpus bound: the flywheel chases current traffic,
        # so old streams age out first
        self._streams: Deque[List[int]] = deque(maxlen=int(max_streams))
        self._distills = 0

    # ---------------------------------------------------------- corpus
    def ingest(self, stream) -> int:
        """Add one served stream: a `GenerationResult` (prompt + emitted
        tokens, the target's sequence verbatim) or a token iterable.
        Returns the number of training windows it yields."""
        if hasattr(stream, "tokens") and hasattr(stream, "prompt"):
            toks = [int(x) for x in stream.prompt] \
                + [int(x) for x in stream.tokens]
        else:
            toks = [int(x) for x in stream]
        self._streams.append(toks)
        return len(self._windows(toks))

    @property
    def streams(self) -> int:
        return len(self._streams)

    @property
    def distills(self) -> int:
        return self._distills

    def _windows(self, toks: List[int]) -> List[np.ndarray]:
        """Fixed-shape (seq_len+1) windows over one stream: stride
        seq_len, plus one end-anchored window so the stream's tail (the
        freshest target behaviour) is never dropped."""
        L = self.seq_len
        n = len(toks)
        if n < L + 1:
            return []
        starts = list(range(0, n - L, L))
        if starts[-1] != n - L - 1:
            starts.append(n - L - 1)
        return [np.asarray(toks[s0:s0 + L + 1], np.int32)
                for s0 in starts]

    def _samples(self):
        from bigdl_tpu_torch.dataset.sample import Sample

        out = []
        for toks in self._streams:
            for w in self._windows(toks):
                out.append(Sample(w[:-1], w[1:]))
        return out

    # ----------------------------------------------------------- train
    def distill(self):
        """One distillation round: warm-start from the model's current
        variables, train on every ingested window, return a fresh
        variables tree for `swap_draft`. On success the model's
        variables advance to the distilled weights (the next round
        warm-starts from here); on failure they are restored untouched.
        Live engines notice neither: their serving layout was built from
        the variables at construction or swap time."""
        from bigdl_tpu_torch import nn
        from bigdl_tpu_torch.dataset import DataSet
        from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
        from bigdl_tpu_torch.optim import Adam, Optimizer, Trigger
        from bigdl_tpu_torch.parallel.mesh import make_mesh

        samples = self._samples()
        if not samples:
            raise RuntimeError(
                "distill() with an empty corpus: ingest() at least one "
                f"stream of >= seq_len+1 (= {self.seq_len + 1}) tokens "
                "first")
        model = self._model
        prev = model.variables
        # train on copies: the serving layout must never alias training
        # state
        model.variables = tree_map(lambda t: t.detach().clone(), prev)
        mesh, own_mesh = self.mesh, None
        ok = False
        try:
            opt = (Optimizer(model, DataSet.array(samples),
                             nn.ChunkedSoftmaxCE(),
                             batch_size=min(self.batch_size,
                                            len(samples)),
                             seed=self.seed)
                   .set_optim_method(Adam(learningrate=self.learningrate))
                   .set_end_when(Trigger.max_epoch(self.epochs)))
            if mesh is None:
                # the background-loop default: a one-rank mesh on the
                # draft's device keeps the ZeRO-2 path (flat master
                # shards) without a second process
                device = tree_leaves(prev)[0].device
                mesh = own_mesh = make_mesh({"data": 1}, device=device)
            opt.set_mesh(mesh, zero=self.zero)
            opt.optimize()
            new_vars = model.variables
            ok = True
        finally:
            if own_mesh is not None:
                own_mesh.close()
            if not ok:
                model.variables = prev
        self._distills += 1
        return new_vars
