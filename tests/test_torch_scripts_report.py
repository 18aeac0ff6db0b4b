"""The port's report surfaces (bigdl_tpu_torch/scripts/obs_report.py and
ops_console.py) against the JAX package's (scripts/obs_report.py and
ops_console.py) on the CPU.

One JSONL event file, written by the port's loadgen (SLO objectives,
tenants with a noisy neighbour, multi-turn sessions over the host spill
tier, a metrics snapshot at the end), is fed to both packages'
renderers: `summarize`, `render` and the CLI's text (with its
`--perfetto` export) are identical, and so is the console's frame; two
renders are byte-identical. The console's `--url` source polls a
ScrapeServer over the port's registry on localhost and renders the same
frame as the JAX console's `render_scrape_frame` on the same scrape.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

import bigdl_tpu.obs as jobs
from bigdl_tpu_torch import obs as tobs
from bigdl_tpu_torch.scripts import loadgen as tlg
from bigdl_tpu_torch.scripts import obs_report as treport
from bigdl_tpu_torch.scripts import ops_console as tconsole

ROOT = Path(__file__).resolve().parent.parent
ARGV = ("--requests 20 --sessions 2 --host-blocks 8 --tenants 2 "
        "--noisy-tenant 1 --slo-target-p99 2.0 --slo-goodput 0.95 "
        "--seed 1 --device cpu").split()


def _jax_script(name):
    mod = sys.modules.get(f"bigdl_{name}")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"bigdl_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[f"bigdl_{name}"] = mod
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def run_file(tmp_path_factory):
    """The JSONL of one port loadgen run, and the registry's scrape."""
    path = tmp_path_factory.mktemp("obs") / "run.jsonl"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    prev = tobs.set_enabled(True)
    mp = pytest.MonkeyPatch()
    mp.setenv("BIGDL_OBS_EVENTS", str(path))
    try:
        tobs.reset_all()
        report = tlg.run(ARGV)
        tobs.log_metrics_snapshot()
        srv = tobs.ScrapeServer()
        url = f"http://127.0.0.1:{srv.start()}"
        try:
            tconsole.main(["--url", url])       # warm the route
            yield path, report, srv, url
        finally:
            srv.close()
    finally:
        mp.undo()
        torch.set_num_threads(threads)
        tobs.reset_all()
        tobs.set_enabled(prev)
        jobs.reset_all()


def _events(path):
    return tobs.read_jsonl(str(path))


def test_run_file_covers_the_sections(run_file):
    path, report, _, _ = run_file
    kinds = {e["kind"] for e in _events(path)}
    assert {"request_terminal", "metrics_snapshot", "tenant_throttled",
            "alert_firing", "prefix_hit"} <= kinds
    assert report["slo"]["alerts"]["fired"] >= 1


def test_summaries_and_renders_equal_the_reference(run_file):
    path, _, _, _ = run_file
    jrep = _jax_script("obs_report")
    events = _events(path)
    assert json.dumps(treport.summarize(events), sort_keys=True,
                      default=str) == json.dumps(
        jrep.summarize(events), sort_keys=True, default=str)
    text = treport.render(events)
    assert text == jrep.render(events)
    assert treport.render(_events(path)) == text       # byte-identical
    for section in ("serving:", "serving SLO:", "tenants", "alerts",
                    "metrics"):
        assert section in text, section


def test_cli_text_and_perfetto_equal_the_reference(run_file, tmp_path,
                                                   capsys):
    path, _, _, _ = run_file
    jrep = _jax_script("obs_report")
    outs = []
    pf = tmp_path / "journeys.json"
    for main in (treport.main, jrep.main):
        assert main([str(path), "--tail", "5", "--perfetto", str(pf)]) == 0
        outs.append((capsys.readouterr().out, pf.read_bytes()))
    assert outs[0] == outs[1]
    assert json.loads(outs[0][1])


def test_console_frame_equals_the_reference(run_file, capsys):
    path, _, _, _ = run_file
    jcon = _jax_script("ops_console")
    events = _events(path)
    frame = tconsole.render_frame(events)
    assert frame == jcon.render_frame(events)
    assert tconsole.main([str(path)]) == 0
    assert capsys.readouterr().out == frame + "\n"
    assert tconsole.render_frame(_events(path)) == frame


def test_console_url_frame_equals_the_reference(run_file, capsys):
    _, _, _, url = run_file
    jcon = _jax_script("ops_console")
    seen = {}
    fetch = tconsole._fetch

    def recording(u):
        seen[u.rsplit("/", 1)[1]] = body = fetch(u)
        return body

    capsys.readouterr()
    with mock.patch.object(tconsole, "_fetch", recording):
        assert tconsole.main(["--url", url]) == 0
    frame = capsys.readouterr().out
    want = jcon.render_scrape_frame(json.loads(seen["health"]),
                                    seen["metrics"].decode())
    assert frame == want + "\n"
    assert "pool" in frame


def test_both_surfaces_run_as_modules(run_file):
    path, _, _, _ = run_file
    for name in ("obs_report", "ops_console"):
        out = subprocess.run(
            [sys.executable, "-m", f"bigdl_tpu_torch.scripts.{name}",
             str(path)], cwd=ROOT, capture_output=True, text=True,
            timeout=120, check=True)
        mod = treport if name == "obs_report" else tconsole
        want = mod.render(_events(path)) if name == "obs_report" \
            else mod.render_frame(_events(path))
        assert out.stdout == want + "\n", name
