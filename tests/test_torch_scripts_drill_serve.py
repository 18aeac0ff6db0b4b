"""The port script's single-engine serving legs against the JAX
package's: serve_poison, serve_overload, serve_deadline, serve_retry,
serve_watchdog, serve_prefix and serve_spill
(bigdl_tpu_torch/scripts/fault_drill.py vs scripts/fault_drill.py, on
the CPU, with tests/test_torch_fleet_drills.py's harness: the JAX
drill's tiny LM weights carried in, the leg's own gates passing on the
port and every digest field equal to the reference's); and the script's
CLI (`python -m bigdl_tpu_torch.scripts.fault_drill`) on the CPU, its
default device the card.
"""

import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest

import test_torch_fleet_drills as fd
from bigdl_tpu_torch.scripts import fault_drill as pdrill

_fresh = fd._fresh
ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("leg", ["serve_poison", "serve_overload",
                                 "serve_deadline", "serve_retry",
                                 "serve_watchdog", "serve_prefix",
                                 "serve_spill"])
def test_port_serving_leg_matches_the_reference(tmp_path, leg):
    fd.check_leg(tmp_path, leg)


def test_cli_runs_as_a_module_and_defaults_to_the_card(capsys):
    out = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.scripts.fault_drill",
         "--legs", "serve_overload,nan_skip", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    lines = [json.loads(ln) for ln in out.stdout.splitlines()]
    assert [ln.get("leg") for ln in lines] == ["serve_overload", "nan_skip",
                                               None]
    assert lines[-1] == {"ok": True, "legs": ["serve_overload", "nan_skip"]}
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pdrill.main(["--legs", "serve_overload"])
