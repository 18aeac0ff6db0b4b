"""The port's small utils (bigdl_tpu_torch/utils/: shape, file,
logger_filter, debug, profiler, engine) and its Spark adapter
(dataset/spark_adapter.py) against the JAX package's, where the two
share a meaning, on the CPU.

- `Shape` equals the JAX Shape; `file.py`'s pickles and npz trees load
  both ways (a torch tensor is written as its numpy array);
- `redirect_logs` sends a noisy logger to the file and takes torch's
  loggers where the JAX package names jax's;
- `assert_all_finite` names the same key paths as the JAX function;
  `debug_nans` raises at the op that made the NaN (forward, and in the
  backward), and not when disabled; `deterministic` repeats a stream
  and restores the deterministic-algorithms flag;
- `profiler.trace` writes a Chrome/TensorBoard trace holding the step
  and annotation ranges and the ops; `FencedTimer` times;
- `Engine` reports host cores as the JAX Engine does, one node without
  a group, its CUDA devices, the JAX Engine's refusal of a partial
  launcher environment, a one-rank default mesh; under a two-rank gloo
  group, two nodes and two devices, and the Spark adapter's default
  shard is the rank's (the ranks' body is in
  tests/test_torch_port_utils_ranks.py, which imports no JAX: spawn
  re-imports it in every rank);
- `rdd_to_dataset` and `dataframe_to_dataset` give the JAX adapter's
  samples for RDD-like objects, dicts of columns and rows.
"""

import json
import logging
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_port_utils_ranks as ranks
from bigdl_tpu.dataset import spark_adapter as jspark
from bigdl_tpu.utils import debug as jdebug
from bigdl_tpu.utils import file as jfile
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.shape import Shape as JShape
from bigdl_tpu_torch.dataset import spark_adapter as pspark
from bigdl_tpu_torch.parallel.launch import spawn
from bigdl_tpu_torch.utils import Engine, Shape, profiler, redirect_logs
from bigdl_tpu_torch.utils import debug as pdebug
from bigdl_tpu_torch.utils import file as pfile
from bigdl_tpu_torch.utils import logger_filter


def test_shape_as_jax():
    for dims in ((1, 28, 28), ((4, 3),), ([2, 5, 7],), ()):
        s, j = Shape(*dims), JShape(*dims)
        assert s == j and tuple(s) == tuple(j)
        assert s.rank == j.rank and s.numel() == j.numel()
        assert isinstance(s, tuple)


def test_file_objects_load_both_ways(tmp_path):
    obj = {"a": 1, "b": [1.5, "x"], "w": np.arange(6.0).reshape(2, 3)}
    pfile.save(obj, str(tmp_path / "p" / "obj.bin"))
    jfile.save(obj, str(tmp_path / "j.bin"))
    for back in (jfile.load(str(tmp_path / "p" / "obj.bin")),
                 pfile.load(str(tmp_path / "j.bin"))):
        assert back["a"] == 1 and back["b"] == [1.5, "x"]
        np.testing.assert_array_equal(back["w"], obj["w"])
    # torch tensors are written as numpy arrays: the JAX side reads them
    pfile.save({"t": torch.arange(4.0), "l": (torch.ones(2),)},
               str(tmp_path / "t.bin"))
    back = jfile.load(str(tmp_path / "t.bin"))
    assert isinstance(back["t"], np.ndarray)
    np.testing.assert_array_equal(back["t"], np.arange(4.0))
    assert isinstance(back["l"], tuple) and back["l"][0].tolist() == [1, 1]
    with pytest.raises(FileExistsError):
        pfile.save(2, str(tmp_path / "j.bin"), overwrite=False)


def test_file_tensor_trees_load_both_ways(tmp_path):
    tree = {"layer1": {"weight": np.arange(6.0, dtype=np.float32)
                       .reshape(2, 3), "bias": np.zeros(3, np.float32)},
            "top": np.ones(2, np.int64)}
    torch_tree = {"layer1": {k: torch.from_numpy(v)
                             for k, v in tree["layer1"].items()},
                  "top": torch.ones(2, dtype=torch.int64)}
    pfile.save_tensors(torch_tree, str(tmp_path / "p.npz"))
    jfile.save_tensors(tree, str(tmp_path / "j.npz"))
    for back in (jfile.load_tensors(str(tmp_path / "p.npz")),
                 pfile.load_tensors(str(tmp_path / "j.npz")),
                 pfile.load_tensors(str(tmp_path / "p.npz"))):
        for k in ("weight", "bias"):
            np.testing.assert_array_equal(back["layer1"][k],
                                          tree["layer1"][k])
            assert back["layer1"][k].dtype == tree["layer1"][k].dtype
        np.testing.assert_array_equal(back["top"], tree["top"])


def test_redirect_logs_to_file(tmp_path):
    assert "torch" in logger_filter._NOISY
    assert not any(n.startswith("jax") for n in logger_filter._NOISY)
    root = logging.getLogger()
    saved = (root.level, list(root.handlers))
    noisy = logging.getLogger("some.noisy.lib")
    try:
        logpath = str(tmp_path / "bigdl.log")
        redirect_logs(logpath, noisy=("some.noisy.lib",))
        noisy.info("hello file")
        noisy.handlers[0].flush()
        assert "hello file" in Path(logpath).read_text()
        assert noisy.propagate is False
    finally:
        for h in noisy.handlers:
            h.close()
        noisy.handlers, noisy.propagate = [], True
        noisy.setLevel(logging.NOTSET)
        root.setLevel(saved[0])
        root.handlers = saved[1]


def test_assert_all_finite_names_the_paths_as_jax():
    tree = {"ok": np.ones(2, np.float32),
            "bad": {"w": np.asarray([1.0, np.nan], np.float32)},
            "list": [np.ones(1, np.float32), np.asarray([np.inf])],
            "ints": np.arange(3)}
    with pytest.raises(FloatingPointError) as jerr:
        jdebug.assert_all_finite({k: (jnp.asarray(v) if not isinstance(
            v, (dict, list)) else v) for k, v in tree.items()},
            name="grads")
    ttree = {"ok": torch.ones(2), "bad": {"w": torch.tensor([1.0, np.nan])},
             "list": [torch.ones(1), torch.tensor([np.inf])],
             "ints": torch.arange(3)}
    with pytest.raises(FloatingPointError) as terr:
        pdebug.assert_all_finite(ttree, name="grads")
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(FloatingPointError) as nerr:
        pdebug.assert_all_finite(tree, name="grads")
    assert str(nerr.value) == str(jerr.value)
    pdebug.assert_all_finite({"w": torch.ones(3)})


def test_debug_nans_traps_the_producing_op():
    x = torch.zeros(3)
    with pdebug.debug_nans():
        y = x + 1.0                     # finite: no trap
        with pytest.raises(FloatingPointError, match="aten.div"):
            x / x
    assert torch.equal(y, torch.ones(3))
    w = torch.zeros(2, requires_grad=True)
    with pdebug.debug_nans():
        loss = w.abs().pow(0.5).sum()   # finite forward, NaN backward
        with pytest.raises((FloatingPointError, RuntimeError),
                           match="nan"):
            loss.backward()
    with pdebug.debug_nans(False):
        assert bool(torch.isnan(x / x).all())
    assert bool(torch.isnan(x / x).all())  # the trap is gone after


def test_deterministic_repeats_and_restores():
    before = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    with pdebug.deterministic(7) as g1:
        assert torch.are_deterministic_algorithms_enabled()
        a = torch.randn(4, generator=g1)
    with pdebug.deterministic(7) as g2:
        b = torch.randn(4, generator=g2)
    assert torch.equal(a, b)
    assert torch.are_deterministic_algorithms_enabled() == before
    assert os.environ.get("CUBLAS_WORKSPACE_CONFIG") == env


def test_profiler_trace_holds_steps_and_ops(tmp_path):
    logdir = str(tmp_path / "tb")
    x = torch.randn(64, 64)
    with profiler.trace(logdir):
        with profiler.step(0):
            with profiler.annotate("region"):
                y = x @ x
    files = [p for p in Path(logdir).rglob("*") if p.is_file()]
    assert files and all(p.name.endswith(".pt.trace.json") for p in files)
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"train_step#0", "region", "aten::mm"} <= names
    with profiler.FencedTimer() as t:
        t.fence(y, {"a": [y]})
    assert t.elapsed is not None and t.elapsed > 0
    profiler.device_sync(y)


def test_engine_on_one_process(monkeypatch):
    Engine.init()
    JEngine.init()
    assert Engine.core_number() == JEngine.core_number() == os.cpu_count()
    assert Engine.node_number() == 1
    assert Engine.local_device_count() == torch.cuda.device_count()
    assert Engine.device_count() == Engine.local_device_count()
    with pytest.raises(ValueError, match="1-D"):
        Engine.default_mesh(("data", "model"), device="cpu")
    mesh = Engine.default_mesh(device="cpu")
    try:
        assert mesh.shape == {"data": 1} and mesh.device.type == "cpu"
    finally:
        mesh.close()
    monkeypatch.setenv("BIGDL_COORDINATOR", "10.0.0.1:8476")
    monkeypatch.delenv("BIGDL_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("BIGDL_PROCESS_ID", raising=False)
    for engine in (Engine, JEngine):
        with pytest.raises(ValueError, match="BIGDL_NUM_PROCESSES"):
            engine.init_distributed()


def test_engine_and_spark_shard_under_a_group(tmp_path):
    views = spawn(ranks.rank_view, 2, str(tmp_path / "w"))
    assert [v[:2] for v in views] == [(2, 2), (2, 2)]
    assert views[0][2] == [0.0, 2.0, 4.0, 6.0, 8.0]
    assert views[1][2] == [1.0, 3.0, 5.0, 7.0, 9.0]


class _FakeRDD:
    def __init__(self, rows):
        self.rows = rows

    def collect(self):
        return list(self.rows)


class _FakeDF:
    def __init__(self, rows):
        self.rows = rows

    def select(self, *cols):
        df = self

        class _Sel:
            rdd = _FakeRDD([{"features": r[cols[0]], "label": r[cols[1]]}
                            for r in df.rows])
        return _Sel()


@pytest.mark.parametrize("case", ["rdd_shard", "rows", "dict_rows",
                                  "samples", "frame", "columns"])
def test_spark_adapter_as_jax(case):
    rows = [(np.ones(3) * i, i % 2) for i in range(10)]
    kw = {"process_id": 1, "num_processes": 2}
    if case == "rdd_shard":
        args = lambda m: (_FakeRDD(rows),)
        fn = "rdd_to_dataset"
    elif case == "rows":
        args, fn, kw = (lambda m: (rows,)), "rdd_to_dataset", {}
    elif case == "dict_rows":
        args = lambda m: ([{"features": f, "label": l} for f, l in rows],)
        fn = "rdd_to_dataset"
    elif case == "samples":
        args = lambda m: ([m.Sample(f, l) for f, l in rows],)
        fn = "rdd_to_dataset"
    elif case == "frame":
        args = lambda m: (_FakeDF([{"f": f, "y": l} for f, l in rows]),
                          "f", "y")
        fn = "dataframe_to_dataset"
    else:
        args = lambda m: ({"features": [f for f, _ in rows],
                           "label": [l for _, l in rows]},)
        fn, kw = "dataframe_to_dataset", {"process_id": 0,
                                          "num_processes": 1}
    import bigdl_tpu.dataset as jd
    import bigdl_tpu_torch.dataset as td

    jds = getattr(jspark, fn)(*args(jd), **kw)
    tds = getattr(pspark, fn)(*args(td), **kw)
    assert tds.size() == jds.size()
    for a, b in zip(tds.elements, jds.elements):
        np.testing.assert_array_equal(a.feature, b.feature)
        np.testing.assert_array_equal(a.label, b.label)


def test_spark_adapter_refuses_half_a_shard():
    for mod in (pspark, jspark):
        with pytest.raises(ValueError, match="together"):
            mod.rdd_to_dataset([(np.zeros(1), 0)], process_id=0)
