"""The port's differentiable collectives (bigdl_tpu_torch/parallel/
collectives.py) on two gloo ranks, each forward and gradient against its
definition — the transposes the JAX package gets from `lax` and from
the custom VJPs of bigdl_tpu/models/transformer.py — and
`Evaluator(mesh)` at data 2 against the single-process Evaluator.

The ranks are spawned once (parallel/launch.spawn); `_scenarios` runs
every case there and returns numpy results, which the tests hold
against numpy definitions. This module imports JAX nowhere (the ranks
import it). The values are small integers, so every sum is exact and
the comparisons are exact; Evaluator results within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

WORLD = 2


def _vec(rank, n=6):
    return torch.arange(n, dtype=torch.float32) + 10 * rank


def _collective_cases(rank):
    from bigdl_tpu_torch.parallel import collectives as C

    out = {"index": C.axis_index("model"), "size": C.axis_size("model")}
    c = torch.arange(6, dtype=torch.float32) + 1 + rank  # per-rank cotangent

    def run(name, fn, x):
        x = x.clone().requires_grad_()
        y = fn(x)
        (g,) = torch.autograd.grad((y * c[:y.numel()].view_as(y)).sum(), x)
        out[name] = (y.detach().numpy(), g.numpy())

    run("tp_identity", lambda x: C.tp_identity(x, "model") * (rank + 1),
        _vec(rank))
    run("tp_reduce", lambda x: C.tp_reduce(x, "model"), _vec(rank))
    w = torch.tensor([2.0, 3.0])[rank]
    run("pair", lambda x: C.tp_reduce(C.tp_identity(x, "model") * w,
                                      "model"), _vec(0))
    run("psum", lambda x: C.psum(x, "model"), _vec(rank))
    run("pmean", lambda x: C.pmean(x, "model"), _vec(rank))
    run("ppermute", lambda x: C.ppermute(x, "model"), _vec(rank))
    run("ppermute_back", lambda x: C.ppermute(x, "model", shift=-1),
        _vec(rank))
    x2 = torch.arange(24, dtype=torch.float32).reshape(4, 6) + 100 * rank
    c2 = torch.arange(24, dtype=torch.float32).reshape(2, 12) + rank
    x2.requires_grad_()
    y2 = C.all_to_all(x2, "model", split_dim=0, concat_dim=1)
    (g2,) = torch.autograd.grad((y2 * c2).sum(), x2)
    out["all_to_all"] = (y2.detach().numpy(), g2.numpy())
    leaves = [_vec(rank, 3), _vec(rank, 2) * 2]
    C.psum_leaves(leaves, "model", mean=True)
    out["psum_leaves"] = [t.numpy() for t in leaves]
    return out


def _eval_data():
    rng = np.random.RandomState(2)
    return (rng.rand(37, 6).astype(np.float32),
            rng.randint(0, 4, 37).astype(np.int32))


def _eval_model():
    from bigdl_tpu_torch import nn

    m = nn.Sequential(nn.Linear(6, 16), nn.ReLU(), nn.Linear(16, 4),
                      nn.LogSoftMax())
    m.variables = m.init(torch.Generator().manual_seed(5), device="cpu")
    return m


def _evaluate(mesh):
    from bigdl_tpu_torch import nn, optim
    from bigdl_tpu_torch.dataset import DataSet, Sample

    xs, ys = _eval_data()
    data = DataSet.array([Sample(x, int(y)) for x, y in zip(xs, ys)])
    res = optim.Evaluator(_eval_model(), mesh=mesh).test(
        data, [optim.Top1Accuracy(), optim.Loss(nn.ClassNLLCriterion())],
        16)
    return {k: r.result() for k, r in res.items()}


def _scenarios(rank, world):
    from bigdl_tpu_torch.parallel import collectives as C
    from bigdl_tpu_torch.parallel import make_mesh

    mesh = make_mesh({"model": world}, device="cpu")
    with C.bind(mesh):
        out = _collective_cases(rank)
    out["evaluator"] = _evaluate(make_mesh({"data": world}, device="cpu"))
    return out


@pytest.fixture(scope="module")
def w2(tmp_path_factory):
    from bigdl_tpu_torch.parallel.launch import spawn

    return spawn(_scenarios, WORLD, str(tmp_path_factory.mktemp("coll")))


def _c(rank, n=6):
    return np.arange(n, dtype=np.float32) + 1 + rank


def _v(rank, n=6):
    return np.arange(n, dtype=np.float32) + 10 * rank


def test_axis_index_and_size(w2):
    assert [r["index"] for r in w2] == [0, 1]
    assert all(r["size"] == WORLD for r in w2)


def test_tp_identity_sums_cotangents_once(w2):
    for r, res in enumerate(w2):
        y, g = res["tp_identity"]
        np.testing.assert_array_equal(y, _v(r) * (r + 1))
        # d/dx sum_r (x * (r+1)) * c_r: every rank's partial, summed once
        np.testing.assert_array_equal(g, 1 * _c(0) + 2 * _c(1))


def test_tp_reduce_sums_forward_and_passes_cotangent(w2):
    for r, res in enumerate(w2):
        y, g = res["tp_reduce"]
        np.testing.assert_array_equal(y, _v(0) + _v(1))
        np.testing.assert_array_equal(g, _c(r))   # identity: not 2 * c


def test_tp_pair_does_not_scale_gradients_by_axis_size(w2):
    """The Megatron f/g pair around a row-split product: the gradient of
    the replicated input is sum_r w_r * c_r on every rank — with a bare
    psum backward after the product it would be twice that."""
    for r, res in enumerate(w2):
        y, g = res["pair"]
        np.testing.assert_array_equal(y, _v(0) * 5.0)
        np.testing.assert_array_equal(g, 2.0 * _c(0) + 3.0 * _c(1))


def test_psum_and_pmean_transpose_is_a_sum(w2):
    for r, res in enumerate(w2):
        y, g = res["psum"]
        np.testing.assert_array_equal(y, _v(0) + _v(1))
        np.testing.assert_array_equal(g, _c(0) + _c(1))
        y, g = res["pmean"]
        np.testing.assert_array_equal(y, (_v(0) + _v(1)) / 2)
        np.testing.assert_array_equal(g, (_c(0) + _c(1)) / 2)
        np.testing.assert_array_equal(res["psum_leaves"][0],
                                      (_v(0, 3) + _v(1, 3)) / 2)
        np.testing.assert_array_equal(res["psum_leaves"][1],
                                      _v(0, 2) + _v(1, 2))


@pytest.mark.parametrize("case, shift", [("ppermute", 1),
                                         ("ppermute_back", -1)])
def test_ppermute_and_its_reverse_shift(w2, case, shift):
    for r, res in enumerate(w2):
        y, g = res[case]
        np.testing.assert_array_equal(y, _v((r - shift) % WORLD))
        # the cotangent comes back from the rank this one sent to
        np.testing.assert_array_equal(g, _c((r + shift) % WORLD))


def test_all_to_all_is_tiled_and_its_backward_inverse(w2):
    xs = [np.arange(24, dtype=np.float32).reshape(4, 6) + 100 * r
          for r in range(WORLD)]
    cs = [np.arange(24, dtype=np.float32).reshape(2, 12) + r
          for r in range(WORLD)]
    for r, res in enumerate(w2):
        y, g = res["all_to_all"]
        want = np.concatenate([x[2 * r:2 * r + 2] for x in xs], axis=1)
        np.testing.assert_array_equal(y, want)
        # rows [2j, 2j+2) went to rank j, landing in its column block r
        want_g = np.concatenate([cs[j][:, 6 * r:6 * r + 6]
                                 for j in range(WORLD)], axis=0)
        np.testing.assert_array_equal(g, want_g)


def test_axis_of_size_one_is_the_identity():
    import torch.distributed as dist

    from bigdl_tpu_torch.parallel import collectives as C
    from bigdl_tpu_torch.parallel import make_mesh

    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="no mesh is bound"):
        C.tp_reduce(x, "data")
    mesh = make_mesh({"data": 1}, device="cpu")
    try:
        with C.bind(mesh):
            for fn in (C.tp_identity, C.tp_reduce, C.psum, C.pmean,
                       C.ppermute):
                assert fn(x, "data") is x
            assert C.all_to_all(x, "data", 0, 0) is x
            with pytest.raises(ValueError, match="not an axis"):
                C.psum(x, "model")
    finally:
        mesh.close()
    assert not dist.is_initialized()


def test_evaluator_mesh_pads_and_masks_like_one_process(w2):
    """37 rows in batches of 16: the last batch of 5 is padded to 6 (its
    last row repeated) and the filler masked; every rank returns the
    single-process results."""
    want = _evaluate(None)
    for res in w2:
        for name, (v, n) in want.items():
            got_v, got_n = res["evaluator"][name]
            assert got_n == n == 37
            np.testing.assert_allclose(got_v, v, rtol=1e-6)
