"""Tensor-parallel serving of the port on four gloo ranks (the w4 half
of tests/test_torch_tp_serving.py, whose helpers it imports): tp = 4
gives the unsharded engine's results bit for bit,
a tp = 2 tree reshards to tp = 4 and back to the host form bitwise and
serves the same tokens, and the greedy tokens equal the JAX engine's at
tp_mesh 4. The tp = 2 tree is a {"data": 2, "model": 2} mesh's (a
mesh spans the world; each data row holds a copy)."""

import numpy as np
import pytest
import torch

import test_torch_tp_serving as tps
from test_torch_tp_serving import KNOBS, CFG, _reqs, _res


def _w4_body(rank, world, init):
    from bigdl_tpu_torch.models.convert import tree_leaves, tree_map
    from bigdl_tpu_torch.models.transformer import (TransformerConfig,
                                                    TransformerLM)
    from bigdl_tpu_torch.parallel import make_mesh
    from bigdl_tpu_torch.serving import (InferenceEngine, Request,
                                         gather_serving_params,
                                         shard_serving_params)

    model = TransformerLM(TransformerConfig(**CFG), device="cpu")
    params = tree_map(torch.from_numpy, init)
    ref = InferenceEngine(model, params, device="cpu", **KNOBS)
    want = [_res(r) for r in ref.run(_reqs(Request))]
    host1 = gather_serving_params(ref._params)
    out = {"ref": want}
    mesh2 = make_mesh({"data": 2, "model": 2}, device="cpu")
    e2 = InferenceEngine(model, params, device="cpu", tp_mesh=mesh2,
                         **KNOBS)
    host2 = gather_serving_params(e2._params, mesh2)
    mesh4 = make_mesh({"model": 4}, device="cpu")
    e4 = InferenceEngine(model, params, device="cpu", tp_mesh=mesh4,
                         **KNOBS)
    out["tp4"] = [_res(r) for r in e4.run(_reqs(Request))]
    out["pool4"] = tuple(e4.pool[0]["k"].shape)
    # tp 2 -> host -> tp 4 -> host, and serve from the resharded tree
    sp4 = shard_serving_params(mesh4, host2)
    host4 = gather_serving_params(sp4, mesh4)
    out["reshard"] = all(
        a.shape == b.shape == c.shape and np.array_equal(a, b)
        and np.array_equal(a, c)
        for a, b, c in zip(tree_leaves(host1), tree_leaves(host2),
                           tree_leaves(host4)))
    out["local_wq"] = tuple(sp4["blocks"][0]["wq"].shape)
    served = InferenceEngine(model, {"params": sp4}, device="cpu",
                             tp_mesh=mesh4, **KNOBS)
    out["from_resharded"] = [_res(r) for r in served.run(_reqs(Request))]
    return out


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    from bigdl_tpu_torch.parallel.launch import spawn

    return spawn(_w4_body, 4, str(tmp_path_factory.mktemp("tp4")),
                 tps._init(), timeout=tps.SPAWN_TIMEOUT)


def test_tp4_results_bitwise_equal_unsharded(w4):
    for res in w4:
        assert res["tp4"] == res["ref"]
        assert res["ref"] == w4[0]["ref"]


def test_reshard_round_trip_bitwise_and_serves(w4):
    for res in w4:
        assert res["reshard"]
        assert res["local_wq"] == (32, 8)
        assert res["from_resharded"] == res["ref"]


def test_greedy_tokens_equal_jax_tp4_engine(w4):
    tps.jax_tp_greedy_check(4, w4[0]["tp4"])
