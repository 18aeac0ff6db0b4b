"""Sequence parallelism of the port (bigdl_tpu_torch/parallel/
ring_attention.py) on four gloo ranks, after tests/test_ring_attention.py:
ring, zigzag and Ulysses attention through `make_ring_attention`, their
outputs and the gradients of q, k and v, against full attention
(`ops.attention_reference`) and, the causal cases, against the JAX
package's `make_ring_attention` on the same number of the CPU devices
that tests/conftest.py forces.

The ranks are spawned once; they build two meshes over the four ranks —
{"data": 2, "seq": 2} (every mode, the sequence split over 2, each data
row computing the same) and {"seq": 4} (zigzag balance over 4) — and
return every rank's results; this module imports JAX only inside its
tests. Tolerance (fp32): outputs and gradients within 1e-5 absolute;
every rank returns the same global output and gradients.
"""

import numpy as np
import pytest
import torch

WORLD = 4
B, H, S, D = 1, 4, 16, 8
TOL = 1e-5
MODES = [("ring", False), ("ring", True), ("zigzag", True),
         ("ulysses", False), ("ulysses", True)]
SEQ4_MODES = [("zigzag", True)]


def _qkvw():
    rng = np.random.RandomState(0)
    return [rng.randn(B, H, S, D).astype(np.float32) for _ in range(4)]


def _run(fn, arrays):
    q, k, v, w = (torch.from_numpy(a) for a in arrays)
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _scenarios(rank, world):
    from bigdl_tpu_torch.parallel import make_mesh, make_ring_attention

    arrays = _qkvw()
    out = {}
    for name, axes in (("seq2", {"data": 2, "seq": 2}),
                       ("seq4", {"seq": 4})):
        mesh = make_mesh(axes, device="cpu")
        for mode, causal in (MODES if name == "seq2" else SEQ4_MODES):
            fn = make_ring_attention(mesh, "seq", causal=causal, mode=mode)
            out[(name, mode, causal)] = _run(fn, arrays)
        bad = [a[:, :3] for a in arrays]    # 3 heads over a split of 2/4
        try:
            make_ring_attention(mesh, "seq", mode="ulysses")(*(
                torch.from_numpy(a) for a in bad[:3]))
        except ValueError as e:
            out[(name, "bad_heads")] = str(e)
        odd = [a[:, :, :6] for a in arrays]  # 6 rows over a split of 4
        try:
            make_ring_attention(mesh, "seq", causal=True)(*(
                torch.from_numpy(a) for a in odd[:3]))
        except ValueError as e:
            out[(name, "bad_seq")] = str(e)
    return out


@pytest.fixture(scope="module")
def w4(tmp_path_factory):
    from bigdl_tpu_torch.parallel.launch import spawn

    return spawn(_scenarios, WORLD, str(tmp_path_factory.mktemp("ring")))


def _full(causal):
    from bigdl_tpu_torch.ops.flash_attention import attention_reference

    return _run(lambda q, k, v: attention_reference(q, k, v, causal=causal),
                _qkvw())


def _jax(n, mode, causal):
    import jax
    import jax.numpy as jnp

    from bigdl_tpu.parallel import make_mesh, make_ring_attention

    mesh = make_mesh({"seq": n}, devices=jax.devices()[:n])
    fn = make_ring_attention(mesh, "seq", causal=causal, mode=mode)
    q, k, v, w = (jnp.asarray(a) for a in _qkvw())

    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(fn, q, k, v)
        return (out,) + vjp(w)

    # backend optimisation 0: half the compile time, the same HLO
    step = jax.jit(out_and_grads).lower(q, k, v).compile(
        {"xla_backend_optimization_level": 0})
    return [np.asarray(a) for a in step(q, k, v)]


CASES = [("seq2", 2) + m for m in MODES] + [("seq4", 4) + m
                                           for m in SEQ4_MODES]


@pytest.mark.parametrize("name, n, mode, causal", CASES,
                         ids=[f"{c[0]}-{c[2]}-"
                              f"{'causal' if c[3] else 'full'}"
                              for c in CASES])
def test_matches_full_attention_and_jax(w4, name, n, mode, causal):
    """Every case against full attention; the causal ones (each mode
    once at seq=2, zigzag at 4) also against the JAX package's."""
    oracles = [("full", _full(causal))]
    if causal:
        oracles.append(("JAX", _jax(n, mode, causal)))
    for rank in range(WORLD):
        got = w4[rank][(name, mode, causal)]
        for oracle, want in oracles:
            for what, g, f in zip(("out", "dq", "dk", "dv"), got, want):
                np.testing.assert_allclose(
                    g, f, atol=TOL, rtol=0,
                    err_msg=f"{what} vs {oracle}, rank {rank}")


def test_refusals(w4):
    from bigdl_tpu_torch.parallel import make_mesh, make_ring_attention
    from bigdl_tpu_torch.parallel.ring_attention import zigzag_order

    for res in w4:
        assert "not divisible by axis size" in res[("seq2", "bad_heads")]
        assert "not divisible by axis size" in res[("seq4", "bad_heads")]
        assert "does not divide" in res[("seq4", "bad_seq")]
    with pytest.raises(ValueError, match="divisible by 2·2"):
        zigzag_order(2, 6)
    mesh = make_mesh({"seq": 1}, device="cpu")
    try:
        with pytest.raises(ValueError, match="only applies to causal"):
            make_ring_attention(mesh, "seq", causal=False, mode="zigzag")
        with pytest.raises(ValueError, match="ring|ulysses|zigzag"):
            make_ring_attention(mesh, "seq", mode="spiral")
    finally:
        mesh.close()


def test_zigzag_layout_matches_jax():
    from bigdl_tpu.parallel.ring_attention import zigzag_order as jorder

    from bigdl_tpu_torch.parallel.ring_attention import (zigzag_order,
                                                         zigzag_positions)

    for n, s in ((2, 8), (4, 16), (4, 32)):
        np.testing.assert_array_equal(zigzag_order(n, s).numpy(),
                                      np.asarray(jorder(n, s)))
        # every rank holds one front and one mirrored back half-chunk
        pos = zigzag_positions(n, s // n)
        assert sorted(torch.cat(pos).tolist()) == list(range(s))
