"""Sparse input layers and the sparse tensor — wide and embedding-bag
models.

Ports bigdl_tpu/nn/sparse.py (reference: tensor/SparseTensor.scala,
nn/SparseLinear.scala, nn/LookupTableSparse.scala,
nn/SparseJoinTable.scala). The JAX package's fixed-capacity COO
encoding is kept, so one batch is

    indices (B, K) int   column ids, padded with 0
    values  (B, K) float padded with 0.0 (pads contribute nothing)

`encode_sparse` builds it from per-row (ids, vals) lists. The layers
are a gather and an `einsum`, as in the JAX package; the embedding's
gradient is autograd's scatter-add (`index_put_` with accumulation).
`SparseTensor` is the general COO matrix with a static nnz capacity
(padded entries hold value 0 at index (0, ..., 0)); its products are a
gather and an `index_add_`. It is a plain class (the JAX one is a
pytree): differentiate with respect to `values` through
`with_values`, or close over it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.nn.initialization import Xavier
from bigdl_tpu_torch.nn.module import Module


def encode_sparse(rows: Sequence[Tuple[Sequence[int], Sequence[float]]],
                  capacity: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row (ids, vals) -> fixed-capacity (indices int32, values
    float32) host arrays."""
    if capacity is None:
        capacity = max((len(ids) for ids, _ in rows), default=1)
    n = len(rows)
    indices = np.zeros((n, capacity), np.int32)
    values = np.zeros((n, capacity), np.float32)
    for i, (ids, vals) in enumerate(rows):
        k = len(ids)
        if k > capacity:
            raise ValueError(f"row {i} has {k} nnz > capacity {capacity}")
        indices[i, :k] = np.asarray(ids, np.int32)
        values[i, :k] = np.asarray(vals, np.float32)
    return indices, values


class SparseLinear(Module):
    """y = sparse_x . W + b over COO input (indices, values); weight
    (in, out), Xavier (reference: nn/SparseLinear.scala)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, name: Optional[str] = None):
        super().__init__(name=name)
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias

    def init_params(self, generator=None):
        p = {"weight": Xavier()(generator,
                                (self.input_size, self.output_size),
                                fan_in=self.input_size,
                                fan_out=self.output_size)}
        if self.with_bias:
            p["bias"] = torch.zeros(self.output_size)
        return p

    def apply(self, variables, input, training=False, rng=None):
        indices, values = input[0], input[1]
        p = variables["params"]
        rows = p["weight"][indices.long()]           # (B, K, out)
        y = torch.einsum("bk,bko->bo", values, rows)
        if self.with_bias:
            y = y + p["bias"]
        return y, variables["state"]


class LookupTableSparse(Module):
    """Embedding bag: the weighted embeddings of an id set combined by
    `combiner` sum | mean | sqrtn (reference:
    nn/LookupTableSparse.scala); weight (n_index, n_output),
    N(0, 0.05^2)."""

    def __init__(self, n_index: int, n_output: int,
                 combiner: str = "sum", name: Optional[str] = None):
        super().__init__(name=name)
        if combiner not in ("sum", "mean", "sqrtn"):
            raise ValueError(f"unknown combiner {combiner!r}")
        self.n_index = n_index
        self.n_output = n_output
        self.combiner = combiner

    def init_params(self, generator=None):
        return {"weight": torch.randn(self.n_index, self.n_output,
                                      generator=generator) * 0.05}

    def apply(self, variables, input, training=False, rng=None):
        indices, values = input[0], input[1]
        emb = variables["params"]["weight"][indices.long()]  # (B, K, D)
        out = torch.einsum("bk,bkd->bd", values, emb)
        if self.combiner != "sum":
            if self.combiner == "sqrtn":
                w = torch.sqrt((values * values).sum(dim=-1, keepdim=True))
            else:
                # |v| with jnp.abs's derivative at 0 (+1, where torch's
                # abs gives 0), so the values' gradients agree at pads
                w = torch.where(values >= 0, values, -values).sum(
                    dim=-1, keepdim=True)
            out = out / torch.clamp(w, min=1e-8)
        return out, variables["state"]


class SparseTensor:
    """Fixed-capacity COO sparse tensor with math ops (reference:
    tensor/SparseTensor.scala, SparseTensorMath.scala,
    SparseTensorBLAS.scala). indices (nnz, ndim) int32, values (nnz,),
    shape static; padded entries carry value 0 at index (0, ..., 0) and
    contribute nothing to any op. Duplicate coordinates sum."""

    def __init__(self, indices, values, shape):
        self.indices = torch.as_tensor(indices, dtype=torch.int32)
        self.values = torch.as_tensor(values)
        self.shape = tuple(int(s) for s in shape)

    @staticmethod
    def from_dense(x, capacity: Optional[int] = None) -> "SparseTensor":
        """Host-side: the COO of the nonzeros of `x` (row-major order)."""
        x = np.asarray(x)
        coords = np.argwhere(x != 0)
        vals = x[tuple(coords.T)]
        nnz = len(vals)
        capacity = capacity or max(nnz, 1)
        if nnz > capacity:
            raise ValueError(f"{nnz} nonzeros > capacity {capacity}")
        idx = np.zeros((capacity, x.ndim), np.int32)
        val = np.zeros((capacity,), x.dtype)
        idx[:nnz] = coords
        val[:nnz] = vals
        return SparseTensor(idx, val, x.shape)

    @property
    def nnz_capacity(self) -> int:
        return self.values.shape[0]

    def with_values(self, values) -> "SparseTensor":
        """Same sparsity pattern, new values (the differentiable leaf)."""
        return SparseTensor(self.indices, values, self.shape)

    def to(self, device) -> "SparseTensor":
        return SparseTensor(self.indices.to(device),
                            self.values.to(device), self.shape)

    def _coords(self):
        return tuple(self.indices.long().T)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_put(self._coords(), self.values, accumulate=True)

    def transpose(self) -> "SparseTensor":
        if len(self.shape) != 2:
            raise ValueError("transpose needs a 2-D SparseTensor")
        return SparseTensor(self.indices.flip(1), self.values,
                            self.shape[::-1])

    def scale(self, alpha) -> "SparseTensor":
        return SparseTensor(self.indices, self.values * alpha, self.shape)

    def add(self, other: "SparseTensor") -> "SparseTensor":
        """Union of nonzeros (duplicates kept: every op sums them)."""
        if self.shape != other.shape:
            raise ValueError(f"shape mismatch {self.shape} {other.shape}")
        return SparseTensor(torch.cat([self.indices, other.indices]),
                            torch.cat([self.values, other.values]),
                            self.shape)

    def mul_dense(self, dense) -> "SparseTensor":
        """Elementwise sparse * dense, keeping this sparsity."""
        return SparseTensor(self.indices, self.values * dense[self._coords()],
                            self.shape)

    def mm(self, dense: torch.Tensor) -> torch.Tensor:
        """sparse (M, N) @ dense (N, K) -> dense (M, K): one gather and
        one scatter-add (reference: SparseTensorBLAS.coomm)."""
        if len(self.shape) != 2:
            raise ValueError("mm needs a 2-D SparseTensor")
        rows, cols = self.indices[:, 0].long(), self.indices[:, 1].long()
        contrib = self.values[:, None] * dense[cols]          # (nnz, K)
        out = torch.zeros((self.shape[0], dense.shape[1]),
                          dtype=contrib.dtype, device=contrib.device)
        return out.index_add(0, rows, contrib)

    def __matmul__(self, dense) -> torch.Tensor:
        return self.mm(dense)

    def mv(self, vec: torch.Tensor) -> torch.Tensor:
        """sparse (M, N) @ vec (N,) -> (M,)."""
        return self.mm(vec[:, None])[:, 0]

    def dot(self, dense: torch.Tensor) -> torch.Tensor:
        """<sparse, dense> over all elements."""
        return (self.values * dense[self._coords()]).sum()

    def __repr__(self):
        return (f"SparseTensor(shape={self.shape}, "
                f"nnz_capacity={self.nnz_capacity})")


def addmm(beta, c, alpha, sparse: SparseTensor, dense) -> torch.Tensor:
    """beta C + alpha (sparse @ dense) (reference: SparseTensorMath.addmm)."""
    return beta * c + alpha * sparse.mm(dense)


def addmv(beta, y, alpha, sparse: SparseTensor, vec) -> torch.Tensor:
    """beta y + alpha (sparse @ vec) (reference: SparseTensorMath.addmv)."""
    return beta * y + alpha * sparse.mv(vec)


class SparseJoinTable(Module):
    """Join batch-COO inputs along the feature axis (reference:
    nn/SparseJoinTable.scala). Input: (indices (B, Ki), values (B, Ki))
    pairs, one for each of `input_sizes`; output: one (B, sum Ki) pair
    whose column ids are offset by the sizes of the inputs before
    them."""

    def __init__(self, input_sizes: Sequence[int],
                 name: Optional[str] = None):
        super().__init__(name=name)
        self.input_sizes = [int(s) for s in input_sizes]

    def apply(self, variables, *inputs, training=False, rng=None):
        if len(inputs) == 1 and isinstance(inputs[0], (tuple, list)) \
                and not hasattr(inputs[0][0], "ndim"):
            inputs = tuple(inputs[0])
        if len(inputs) != len(self.input_sizes):
            raise ValueError(
                f"SparseJoinTable: got {len(inputs)} inputs for "
                f"{len(self.input_sizes)} input_sizes")
        offset = 0
        idx_parts, val_parts = [], []
        for (indices, values), size in zip(inputs, self.input_sizes):
            idx_parts.append(indices + offset)
            val_parts.append(values)
            offset += size
        return (torch.cat(idx_parts, dim=1),
                torch.cat(val_parts, dim=1)), variables["state"]
