"""The training CLI's `--records` path (bigdl_tpu_torch/models/train.py)
against the JAX package's: ResNet-20 from BDLS record shards with pad
and flip augmentation, both packages on their Python planes so that the
batches are the same, from one initial checkpoint (see
test_torch_train_cli.py), one epoch of 2 steps of SGD (lr 0.05,
momentum).

Each leaf is compared by the relative norm |a - b| / |b| of its update
(final minus initial weights), of its momentum and of its running
statistics, and all leaves together by the same norm over the
concatenation. Read here: updates 4.4e-2 at the worst leaf and 8.6e-3
over all (norms per leaf 0.03-0.9), momentum 6.7e-2 and 1.6e-2, running
statistics 5.8e-5 and 1.1e-5. Limits: updates and momentum 0.1 a leaf
and 3e-2 over all, running statistics 2e-4 a leaf. The control skips
the port's second update: 0.53 (updates) and 0.69 (momentum) over all,
which the limits must refuse.

Where the gap comes from: test_torch_train_cli_fp64.py (the JAX
package's fp32 batch norm, which two steps of momentum carry into the
numbers above).
"""

import unittest.mock as mock

import numpy as np

import test_torch_train_cli as tc

LEAF_TOL, ALL_TOL, STATE_TOL = 0.1, 3e-2, 2e-4
ARGV = ["--model", "resnet20-cifar", "--recordsAug", "pad2,hflip",
        "-b", "32", "--maxEpoch", "1", "--learningRate", "0.05"]


def _rel(a, b):
    """(largest per-leaf, overall) |a - b| / |b| over lists of arrays."""
    a = [np.asarray(x, np.float64) for x in a]
    b = [np.asarray(x, np.float64) for x in b]
    per = max(np.linalg.norm(x - y) / np.linalg.norm(y)
              for x, y in zip(a, b))
    cat = [np.concatenate([x.ravel() for x in t]) for t in (a, b)]
    return per, np.linalg.norm(cat[0] - cat[1]) / np.linalg.norm(cat[1])


def _gaps(ported, jax_ck, init):
    """{updates, momentum, state: (per leaf, overall)} of the port's
    checkpoint against the JAX package's."""
    from bigdl_tpu_torch.models.convert import tree_leaves

    (tv, ts, _, _), (jv, js, _, _) = ported, jax_ck
    w0 = [t.numpy() for t in tree_leaves(init["params"])]
    upd = [[t.numpy() - w for t, w in zip(tree_leaves(v["params"]), w0)]
           for v in (tv, jv)]
    return {"updates": _rel(*upd),
            "momentum": _rel([t.numpy() for t in tree_leaves(ts)],
                             [t.numpy() for t in tree_leaves(js)]),
            "state": _rel([t.numpy() for t in tree_leaves(tv["state"])],
                          [t.numpy() for t in tree_leaves(jv["state"])])}


def _within(g):
    return (all(g[k][0] <= LEAF_TOL and g[k][1] <= ALL_TOL
                for k in ("updates", "momentum"))
            and g["state"][0] <= STATE_TOL)


def test_resnet20_records_cli_matches_jax(tmp_path):
    from bigdl_tpu.models import resnet
    from bigdl_tpu_torch.optim import optim_method
    from bigdl_tpu_torch.serialization.checkpoint import Checkpoint

    shards, _, _ = tc._record_shards(tmp_path)
    ck = str(tmp_path / "ck")
    tc._initial_checkpoint(resnet.build_cifar(20, 10), 2, ck)
    init = Checkpoint(ck).load()[0]
    argv = ARGV + ["--records", shards]
    out = tc._run_both(argv, ck, masked_planes=True)
    assert out["torch"][2] == out["jax"][2]
    assert out["torch"][2]["neval"] == 2
    gaps = _gaps(out["torch"], out["jax"], init)
    assert _within(gaps), gaps

    # the control: the port skips its second update
    real, calls = optim_method.SGD.update, []

    def update(self, *args):
        calls.append(1)
        if len(calls) != 2:
            real(self, *args)

    with mock.patch.object(optim_method.SGD, "update", update):
        skipped = tc._run_both(argv, ck, masked_planes=True,
                               pkgs=("torch",), tag="-skip")
    control = _gaps(skipped["torch"], out["jax"], init)
    assert len(calls) == 2
    assert not _within(control), control
