"""Torch interop: import `torch.nn` models into the port's modules.

Ports bigdl_tpu/utils/torch_interop.py (reference: utils/TorchFile.scala,
SURVEY.md §2.5; the Torch7 `.t7` wire format itself is
utils/torch_file.py). `from_torch` converts a `torch.nn` module tree
(architecture and weights) into the port's (Module, variables) pair, in
the port's layout, which is the JAX package's:

    Linear.weight  (out, in)      → (in, out)
    Conv2d.weight  (O, I, kH, kW) → (kH, kW, I, O)   (HWIO)
    converted conv/pool/bn modules consume NHWC input — feed images as
    (N, H, W, C); `input_layout="NCHW"` prepends the transpose, so the
    converted model takes the torch model's own input tensors.

Import is by module-type dispatch over `torch.nn` containers; a clear
error names any unsupported layer. The variables land on `device`
(None: the card).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def from_torch(tm, input_layout: str = "NHWC", device: DeviceLike = None
               ) -> Tuple[Module, Dict[str, Any]]:
    """Convert a torch.nn module tree → (Module, variables), the
    variables copies on `device` (None: the card).

    input_layout="NCHW" prepends an NCHW→NHWC transpose so the converted
    model accepts the same input tensors the torch model did.
    """
    import torch.nn as tnn

    dev = resolve_device(device)

    def t(x: torch.Tensor) -> torch.Tensor:
        return x.detach().to(dev, copy=True).contiguous()

    def none():
        return {"params": {}, "state": {}}

    def conv(m):
        mod = nn.SpatialConvolution(
            m.in_channels, m.out_channels,
            kernel_w=m.kernel_size[1], kernel_h=m.kernel_size[0],
            stride_w=m.stride[1], stride_h=m.stride[0],
            pad_w=m.padding[1], pad_h=m.padding[0],
            n_group=m.groups, with_bias=m.bias is not None)
        p = {"weight": t(m.weight.permute(2, 3, 1, 0))}  # OIHW → HWIO
        if m.bias is not None:
            p["bias"] = t(m.bias)
        return mod, {"params": p, "state": {}}

    def linear(m):
        mod = nn.Linear(m.in_features, m.out_features,
                        with_bias=m.bias is not None)
        p = {"weight": t(m.weight.T)}
        if m.bias is not None:
            p["bias"] = t(m.bias)
        return mod, {"params": p, "state": {}}

    def batchnorm(m, spatial: bool):
        cls = nn.SpatialBatchNormalization if spatial \
            else nn.BatchNormalization
        mod = cls(m.num_features, eps=m.eps, momentum=m.momentum or 0.1,
                  affine=m.affine)
        p = {"weight": t(m.weight), "bias": t(m.bias)} if m.affine else {}
        state = {"running_mean": t(m.running_mean),
                 "running_var": t(m.running_var)}
        return mod, {"params": p, "state": state}

    def pair(v):
        return (v, v) if isinstance(v, int) else v

    def pool(m, is_max: bool):
        k = pair(m.kernel_size)
        s = pair(m.stride if m.stride is not None else m.kernel_size)
        pad = pair(m.padding)
        cls = nn.SpatialMaxPooling if is_max else nn.SpatialAveragePooling
        kw = dict(kernel_w=k[1], kernel_h=k[0], stride_w=s[1],
                  stride_h=s[0], pad_w=pad[1], pad_h=pad[0],
                  ceil_mode=bool(getattr(m, "ceil_mode", False)))
        if not is_max:
            kw["count_include_pad"] = bool(getattr(m, "count_include_pad",
                                                   True))
        return cls(**kw), none()

    simple = ((tnn.ReLU, nn.ReLU), (tnn.ReLU6, nn.ReLU6),
              (tnn.Tanh, nn.Tanh), (tnn.Sigmoid, nn.Sigmoid),
              (tnn.GELU, nn.GELU), (tnn.Softmax, nn.SoftMax),
              (tnn.LogSoftmax, nn.LogSoftMax), (tnn.Identity, nn.Identity))

    def convert(m) -> Tuple[Module, Dict[str, Any]]:
        if isinstance(m, tnn.Sequential):
            params, state = {}, {}
            seq = nn.Sequential()
            for child in m:
                cm, cv = convert(child)
                seq.add(cm)
                key = seq._keys[-1]
                params[key] = cv["params"]
                state[key] = cv["state"]
            return seq, {"params": params, "state": state}
        if isinstance(m, tnn.Linear):
            return linear(m)
        if isinstance(m, tnn.Conv2d):
            return conv(m)
        if isinstance(m, tnn.BatchNorm2d):
            return batchnorm(m, spatial=True)
        if isinstance(m, tnn.BatchNorm1d):
            return batchnorm(m, spatial=False)
        if isinstance(m, tnn.Embedding):
            return (nn.LookupTable(m.num_embeddings, m.embedding_dim),
                    {"params": {"weight": t(m.weight)}, "state": {}})
        if isinstance(m, tnn.MaxPool2d):
            return pool(m, is_max=True)
        if isinstance(m, tnn.AvgPool2d):
            return pool(m, is_max=False)
        if isinstance(m, tnn.Dropout):
            return nn.Dropout(m.p), none()
        if isinstance(m, tnn.Flatten):
            if getattr(m, "start_dim", 1) != 1:
                raise NotImplementedError("Flatten(start_dim != 1)")
            return nn.Reshape((-1,), batch_mode=True), none()
        for torch_cls, ours in simple:
            if isinstance(m, torch_cls):
                return ours(), none()
        raise NotImplementedError(
            f"torch module {type(m).__name__} has no bigdl_tpu_torch mapping")

    module, variables = convert(tm)
    if input_layout == "NCHW":
        wrapped = nn.Sequential()
        # NCHW→NHWC via 1-based swap pairs: [N,C,H,W]→[N,H,C,W]→[N,H,W,C]
        wrapped.add(nn.Transpose(((2, 3), (3, 4))))
        wrapped.add(module)
        k0, k1 = wrapped._keys
        variables = {"params": {k0: {}, k1: variables["params"]},
                     "state": {k0: {}, k1: variables["state"]}}
        return wrapped, variables
    return module, variables
