"""Helpers for tests/test_torch_scripts_multihost_*.py (no tests of its
own): the JAX script's runs (scripts/multihost_smoke.py's
`_spawn_group` / `_reap` / `_collect`, never its `launcher`, which
writes MULTIHOST.json) into a test's directory, and the JAX smoke
model's initial parameters as the npz that the port driver's `--init`
reads, so both packages train from the same weights.

Digest tolerance: the port's sum of |params| is held to the JAX run's
within 1e-4 relative. Both send gradients on the bf16 wire, but the JAX
run sums 8 (or 4 x 2) devices' local means where the port sums 2 (or 4)
processes', so the wire rounds other numbers; the smoke's digests
differ by 1.1e-5 relative (46.97855 against 46.97804).
"""

import importlib.util
import os
import socket

import jax
import numpy as np

from bigdl_tpu import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIGEST_RTOL = 1e-4
LAUNCH_TIMEOUT = 120


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_multihost_smoke", os.path.join(REPO, "scripts",
                                            "multihost_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def jax_run(monkeypatch, workdir, leg, n, devices_per_proc, end_iter=6,
            zero2=False):
    """One JAX job of the script's child to its end: each process's
    digest, and each one's sha256."""
    mod = _jax_script()
    # the children set their own device count; keep the test's flags out
    monkeypatch.delenv("XLA_FLAGS", raising=False)
    os.makedirs(workdir, exist_ok=True)
    procs = mod._spawn_group(leg, n, devices_per_proc, _free_port(),
                             str(workdir), end_iter=end_iter, zero2=zero2)
    codes = mod._reap(procs, timeout=LAUNCH_TIMEOUT)
    assert codes == [0] * n, codes
    return mod._collect(str(workdir), n)


def jax_init(path):
    """The JAX smoke model's params at PRNGKey(0), written to `path`."""
    model = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4),
                          nn.LogSoftMax()).build(jax.random.PRNGKey(0))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(jax.device_get(model.variables["params"]), ())
    np.savez(path, **flat)
    return str(path)
