"""The PyTorch port stands alone: no file under bigdl_tpu_torch/, and not
chip_smoke.py, imports `jax`, the JAX package `bigdl_tpu` or
`google.protobuf` (the port has its own codec, utils/protowire.py)
(static AST scan), and importing the port's modules loads none of them
(a fresh interpreter)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "bigdl_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "bigdl_tpu")
BANNED_MODULES = ("google.protobuf",)


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


NEW_IN_SLICE_3 = ("nn/initialization.py", "nn/container.py",
                  "nn/embedding.py", "nn/linear.py", "nn/activation.py",
                  "nn/recurrent.py", "ops/fused_rnn.py", "models/rnn.py")
NEW_IN_SLICE_4 = ("nn/table_ops.py", "optim/validation.py",
                  "optim/evaluator.py")
NEW_IN_SLICE_9 = ("utils/table.py", "nn/reshape.py", "nn/conv.py",
                  "nn/pooling.py", "dataset/mnist.py", "dataset/cifar.py",
                  "models/lenet.py", "models/resnet.py", "models/perf.py")
NEW_IN_SLICE_10 = ("nn/dropout.py", "nn/graph.py", "models/inception.py",
                   "models/vgg.py", "models/alexnet.py",
                   "models/treelstm.py", "ml/__init__.py",
                   "ml/estimator.py")
NEW_IN_SLICE_11 = ("utils/faults.py", "serialization/__init__.py",
                   "serialization/checkpoint.py",
                   "visualization/__init__.py",
                   "visualization/tensorboard.py", "obs/__init__.py",
                   "obs/training.py")
NEW_IN_SLICE_13 = ("dataset/native.py", "dataset/records.py",
                   "dataset/tfrecord.py", "optim/lbfgs.py")
NEW_IN_SLICE_14 = ("nn/attention.py", "nn/sparse.py", "nn/quantized.py",
                   "nn/upsampling.py", "nn/volumetric.py",
                   "models/autoencoder.py", "models/textclassifier.py",
                   "models/ncf.py")
NEW_IN_SLICE_15 = ("parallel/__init__.py", "parallel/mesh.py",
                   "parallel/param_layout.py", "parallel/data_parallel.py",
                   "parallel/distri_optimizer.py", "parallel/launch.py",
                   "dataset/image.py", "dataset/vision.py",
                   "models/train.py")
NEW_IN_SLICE_16 = ("parallel/collectives.py", "parallel/ring_attention.py",
                   "parallel/moe.py", "parallel/tensor_parallel.py",
                   "parallel/pipeline.py", "parallel/multichip.py")
NEW_IN_SLICE_17 = ("serving/tp.py", "keras/__init__.py", "keras/layers.py",
                   "keras/layers_extra.py", "keras/models.py",
                   "keras/functional.py",
                   "serialization/module_serializer.py",
                   "utils/torch_interop.py", "utils/interop.py",
                   "utils/torch_file.py")
NEW_IN_SLICE_18 = ("utils/protowire.py", "utils/caffe/__init__.py",
                   "utils/caffe/bigdl_caffe_pb2.py", "utils/caffe/loader.py",
                   "utils/tf/__init__.py", "utils/tf/bigdl_tf_pb2.py",
                   "utils/tf/loader.py", "utils/tf/saver.py",
                   "dataset/spark_adapter.py", "utils/shape.py",
                   "utils/engine.py", "utils/logger_filter.py",
                   "utils/file.py", "utils/debug.py", "utils/profiler.py")
NEW_IN_SLICE_19 = ("obs/events.py", "obs/exposition.py",
                   "obs/flightrecorder.py", "obs/journey.py", "obs/slo.py",
                   "obs/spans.py", "obs/timeseries.py", "serving/router.py",
                   "serving/tenancy.py", "serving/autoscaler.py",
                   "serving/speculative.py")
NEW_IN_SLICE_20 = ("serving/distill.py", "serving/vision.py",
                   "serving/scenarios.py", "serving/sim.py")
NEW_IN_SLICE_21 = ("analysis/__init__.py", "analysis/__main__.py",
                   "analysis/astutil.py", "analysis/engine.py",
                   "analysis/project.py", "analysis/rules/__init__.py",
                   "analysis/rules/_common.py",
                   "analysis/rules/event_kind_contract.py",
                   "analysis/rules/hidden_device_sync.py",
                   "analysis/rules/lock_discipline.py",
                   "analysis/rules/metric_family_contract.py",
                   "analysis/rules/missing_reference_docstring.py",
                   "analysis/rules/nondeterministic_drill.py",
                   "analysis/rules/telemetry_bypass.py",
                   "analysis/rules/tf_import_in_core.py",
                   "analysis/rules/unfenced_timing.py")
NEW_IN_SLICE_22 = ("scripts/__init__.py", "scripts/loadgen.py",
                   "scripts/obs_report.py", "scripts/ops_console.py",
                   "scripts/fault_drill.py")


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED or module == "google" or any(
        module == b or module.startswith(b + ".") for b in BANNED_MODULES)


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert all(p.exists() for p in PORT_FILES)
    scanned = {str(p.relative_to(ROOT / "bigdl_tpu_torch"))
               for p in PORT_FILES if "bigdl_tpu_torch" in p.parts}
    assert set(NEW_IN_SLICE_3) | set(NEW_IN_SLICE_4) \
        | set(NEW_IN_SLICE_9) | set(NEW_IN_SLICE_10) \
        | set(NEW_IN_SLICE_11) | set(NEW_IN_SLICE_13) \
        | set(NEW_IN_SLICE_14) | set(NEW_IN_SLICE_15) \
        | set(NEW_IN_SLICE_16) | set(NEW_IN_SLICE_17) \
        | set(NEW_IN_SLICE_18) | set(NEW_IN_SLICE_19) \
        | set(NEW_IN_SLICE_20) | set(NEW_IN_SLICE_21) \
        | set(NEW_IN_SLICE_22) <= scanned


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_loads_no_jax():
    code = ("import sys, bigdl_tpu_torch.serving, "
            "bigdl_tpu_torch.models.transformer, "
            "bigdl_tpu_torch.models.convert, "
            "bigdl_tpu_torch.ops.paged_decode, "
            "bigdl_tpu_torch.ops.flash_attention, "
            "bigdl_tpu_torch.ops.losses, bigdl_tpu_torch.nn, "
            "bigdl_tpu_torch.optim, bigdl_tpu_torch.dataset, "
            "bigdl_tpu_torch.utils.precision, "
            "bigdl_tpu_torch.ops.fused_rnn, bigdl_tpu_torch.nn.recurrent, "
            "bigdl_tpu_torch.models.rnn, bigdl_tpu_torch.nn.table_ops, "
            "bigdl_tpu_torch.optim.validation, "
            "bigdl_tpu_torch.optim.evaluator, bigdl_tpu_torch.utils.table, "
            "bigdl_tpu_torch.nn.reshape, bigdl_tpu_torch.nn.conv, "
            "bigdl_tpu_torch.nn.pooling, bigdl_tpu_torch.nn.normalization, "
            "bigdl_tpu_torch.nn.container, bigdl_tpu_torch.dataset.mnist, "
            "bigdl_tpu_torch.dataset.cifar, bigdl_tpu_torch.models.lenet, "
            "bigdl_tpu_torch.models.resnet, bigdl_tpu_torch.models.perf, "
            "bigdl_tpu_torch.nn.dropout, bigdl_tpu_torch.nn.graph, "
            "bigdl_tpu_torch.models.inception, bigdl_tpu_torch.models.vgg, "
            "bigdl_tpu_torch.models.alexnet, "
            "bigdl_tpu_torch.models.treelstm, bigdl_tpu_torch.ml, "
            "bigdl_tpu_torch.ml.estimator, bigdl_tpu_torch.utils.faults, "
            "bigdl_tpu_torch.utils.anomaly, "
            "bigdl_tpu_torch.serialization.checkpoint, "
            "bigdl_tpu_torch.visualization.tensorboard, "
            "bigdl_tpu_torch.obs.training, bigdl_tpu_torch.dataset.native, "
            "bigdl_tpu_torch.dataset.records, "
            "bigdl_tpu_torch.dataset.tfrecord, bigdl_tpu_torch.dataset.text, "
            "bigdl_tpu_torch.optim.lbfgs, bigdl_tpu_torch.nn.attention, "
            "bigdl_tpu_torch.nn.sparse, bigdl_tpu_torch.nn.quantized, "
            "bigdl_tpu_torch.nn.upsampling, bigdl_tpu_torch.nn.volumetric, "
            "bigdl_tpu_torch.models.autoencoder, "
            "bigdl_tpu_torch.models.textclassifier, "
            "bigdl_tpu_torch.models.ncf, bigdl_tpu_torch.parallel, "
            "bigdl_tpu_torch.parallel.launch, bigdl_tpu_torch.dataset.image, "
            "bigdl_tpu_torch.dataset.vision, bigdl_tpu_torch.models.train, "
            "bigdl_tpu_torch.parallel.collectives, "
            "bigdl_tpu_torch.parallel.ring_attention, "
            "bigdl_tpu_torch.parallel.moe, "
            "bigdl_tpu_torch.parallel.tensor_parallel, "
            "bigdl_tpu_torch.parallel.pipeline, "
            "bigdl_tpu_torch.parallel.multichip, "
            "bigdl_tpu_torch.serving.tp, bigdl_tpu_torch.keras, "
            "bigdl_tpu_torch.serialization.module_serializer, "
            "bigdl_tpu_torch.utils.torch_interop, "
            "bigdl_tpu_torch.utils.interop, "
            "bigdl_tpu_torch.utils.torch_file, "
            "bigdl_tpu_torch.utils.protowire, bigdl_tpu_torch.utils.caffe, "
            "bigdl_tpu_torch.utils.tf, bigdl_tpu_torch.utils.engine, "
            "bigdl_tpu_torch.utils.shape, bigdl_tpu_torch.utils.file, "
            "bigdl_tpu_torch.utils.debug, bigdl_tpu_torch.utils.profiler, "
            "bigdl_tpu_torch.utils.logger_filter, "
            "bigdl_tpu_torch.dataset.spark_adapter, bigdl_tpu_torch.obs, "
            "bigdl_tpu_torch.obs.exposition, "
            "bigdl_tpu_torch.obs.flightrecorder, "
            "bigdl_tpu_torch.serving.router, "
            "bigdl_tpu_torch.serving.tenancy, "
            "bigdl_tpu_torch.serving.autoscaler, "
            "bigdl_tpu_torch.serving.speculative, "
            "bigdl_tpu_torch.serving.distill, "
            "bigdl_tpu_torch.serving.vision, "
            "bigdl_tpu_torch.serving.scenarios, "
            "bigdl_tpu_torch.serving.sim, bigdl_tpu_torch.analysis, "
            "bigdl_tpu_torch.analysis.__main__, "
            "bigdl_tpu_torch.analysis.project, "
            "bigdl_tpu_torch.analysis.rules, "
            "bigdl_tpu_torch.scripts.loadgen, "
            "bigdl_tpu_torch.scripts.obs_report, "
            "bigdl_tpu_torch.scripts.ops_console, "
            "bigdl_tpu_torch.scripts.fault_drill; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{BANNED!r} or m.startswith('google.protobuf')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


@pytest.mark.parametrize("name", [p for p in NEW_IN_SLICE_22
                                  if not p.endswith("__init__.py")])
def test_scripts_load_no_file_by_path(name):
    # the JAX scripts load their siblings from scripts/ by path; the
    # port's import theirs as modules, so no script of the port can
    # reach a scripts/*.py file (which would run JAX code)
    path = ROOT / "bigdl_tpu_torch" / name
    src = path.read_text()
    assert "spec_from_file_location" not in src
    assert "importlib.util" not in set(_imported(path))
    assert not any(m.startswith("scripts") for m in _imported(path))
