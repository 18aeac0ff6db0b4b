"""The port's static analysis (bigdl_tpu_torch/analysis/, run as
`python -m bigdl_tpu_torch.analysis`) against the JAX package's
graftlint (bigdl_tpu/analysis/) on the JAX package's own fixtures, and
over the port's tree.

* Shared fixtures: on tests/fixtures/graftlint/, with each per-file
  fixture judged at its rule's scope mapped from `bigdl_tpu/` to
  `bigdl_tpu_torch/`, every ported rule but one gives the same (rule,
  line, col, severity) set as the JAX engine, bad and clean fixtures,
  per-file and cross-module alike. The exception is
  missing-reference-docstring, which enforces the port's own
  convention (each module's docstring names the JAX file it ports) and
  has cases of its own here.
* The torch vocabulary of hidden-device-sync and unfenced-timing
  (`.item()`, `.cpu()`, `.numpy()`, `.tolist()`,
  `torch.cuda.synchronize()`, `Event.synchronize()`), inline.
* The engine's mechanics: suppressions, the shrink-only baseline, one
  parse a file.
* The gate: the port's tree (bigdl_tpu_torch/ and chip_smoke.py) lints
  clean against bigdl_tpu_torch/analysis/baseline.toml, through the
  CLI too, in a process that loads no JAX and no torch. No wall-clock
  budget.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from bigdl_tpu import analysis as janalysis
from bigdl_tpu.analysis import engine as jengine
from bigdl_tpu_torch import analysis as tanalysis
from bigdl_tpu_torch.analysis import engine as tengine

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "graftlint")

jengine._ensure_rules_loaded()
tengine._ensure_rules_loaded()

# the JAX engine's per-file fixtures: rule -> (stem, path judged at)
SHARED_FILE_FIXTURES = {
    "telemetry-bypass": ("telemetry_bypass", "bigdl_tpu/models/fixture.py"),
    "hidden-device-sync": ("hidden_device_sync",
                           "bigdl_tpu/serving/fixture.py"),
    "unfenced-timing": ("unfenced_timing", "bigdl_tpu/utils/fixture.py"),
    "tf-import-in-core": ("tf_import_in_core",
                          "bigdl_tpu/dataset/fixture.py"),
    "nondeterministic-drill": ("nondeterministic_drill",
                               "bigdl_tpu/serving/fixture.py"),
}
SHARED_PROJECT_FIXTURES = {
    "event-kind-contract": "project_event_kind",
    "metric-family-contract": "project_metric_family",
    "lock-discipline": "project_lock_discipline",
}
PORTED = set(SHARED_FILE_FIXTURES) | set(SHARED_PROJECT_FIXTURES) \
    | {"missing-reference-docstring"}


def _port_path(path: str) -> str:
    return "bigdl_tpu_torch/" + path[len("bigdl_tpu/"):]


def _keys(findings):
    return {(f.rule, f.line, f.col, f.severity) for f in findings}


def _fixture(stem: str, kind: str) -> str:
    with open(os.path.join(FIXTURES, f"{stem}_{kind}.py")) as f:
        return f.read()


def _project_paths(stem: str, kind: str):
    d = os.path.join(FIXTURES, f"{stem}_{kind}")
    return sorted(os.path.relpath(os.path.join(d, f), ROOT)
                  .replace(os.sep, "/")
                  for f in os.listdir(d) if f.endswith(".py"))


def _port_lint(rule: str, path: str, source: str):
    return tanalysis.lint_source(path, source, rules=[tanalysis.RULES[rule]])


def test_the_nine_rules_and_no_jax_tracing_rules():
    assert set(tanalysis.RULES) == PORTED
    assert len(PORTED) == 9
    assert set(janalysis.RULES) - set(tanalysis.RULES) == {
        "retrace-hazard", "trace-env-read", "donation-flow"}
    for name, rule in tanalysis.RULES.items():
        assert rule.severity == janalysis.RULES[name].severity, name
        assert all(s.startswith("bigdl_tpu_torch/") or s == "chip_smoke.py"
                   for s in rule.scope), name


@pytest.mark.parametrize("rule", sorted(SHARED_FILE_FIXTURES))
def test_lint_file_agrees_with_the_jax_engine(rule, tmp_path):
    """`lint_file` (one file under a root, every per-file rule or the
    ones given) on a bad fixture laid at its rule's scope: the JAX
    engine's findings, and `lint_source`'s on the same text; a file
    that does not parse gives one parse-error finding in both."""
    stem, path = SHARED_FILE_FIXTURES[rule]
    src = _fixture(stem, "bad")
    for rel in (path, _port_path(path)):
        (tmp_path / rel).parent.mkdir(parents=True, exist_ok=True)
        (tmp_path / rel).write_text(src)
    want = jengine.lint_file(str(tmp_path), path,
                             rules=[janalysis.RULES[rule]])
    got = tanalysis.lint_file(str(tmp_path), _port_path(path),
                              rules=[tanalysis.RULES[rule]])
    assert want and _keys(got) == _keys(want)
    assert got == _port_lint(rule, _port_path(path), src)
    assert {f.rule for f in tanalysis.lint_file(
        str(tmp_path), _port_path(path))} >= {rule}
    (tmp_path / "broken.py").write_text("def f(:\n")
    for engine in (jengine, tanalysis):
        (bad,) = engine.lint_file(str(tmp_path), "broken.py")
        assert (bad.rule, bad.path, bad.line) == ("parse-error",
                                                  "broken.py", 1)


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", sorted(SHARED_FILE_FIXTURES))
def test_file_rules_agree_with_the_jax_engine(rule, kind):
    stem, path = SHARED_FILE_FIXTURES[rule]
    src = _fixture(stem, kind)
    want = jengine.lint_source(path, src, rules=[janalysis.RULES[rule]])
    got = _port_lint(rule, _port_path(path), src)
    assert _keys(got) == _keys(want)
    if kind == "bad":
        assert want, f"{stem}_bad.py fires nothing in the JAX engine"
    assert all(f.path == _port_path(path) for f in got)


@pytest.mark.parametrize("kind", ["bad", "clean"])
@pytest.mark.parametrize("rule", sorted(SHARED_PROJECT_FIXTURES))
def test_project_rules_agree_with_the_jax_engine(rule, kind):
    paths = _project_paths(SHARED_PROJECT_FIXTURES[rule], kind)
    want = janalysis.run_lint(ROOT, paths=paths, rule_names=[rule],
                              project_scope=paths)
    got = tanalysis.run_lint(ROOT, paths=paths, rule_names=[rule],
                             project_scope=paths)
    assert {(f.path,) + k for f, k in zip(got, map(_keys_one, got))} \
        == {(f.path,) + k for f, k in zip(want, map(_keys_one, want))}
    assert bool(want) == (kind == "bad")


def _keys_one(f):
    return (f.rule, f.line, f.col, f.severity)


def test_out_of_scope_paths_are_not_judged():
    src = _fixture("telemetry_bypass", "bad")
    assert _port_lint("telemetry-bypass", "bigdl_tpu/models/x.py",
                      src) == []
    assert _port_lint("telemetry-bypass", "scripts/x.py", src) == []
    assert _port_lint("telemetry-bypass", "chip_smoke.py", src) == []


# ------------------------------------------------ the port's own convention
DOC_CASES = [
    ('"""Ports bigdl_tpu/ops/losses.py."""\n', []),
    ('"""The lint CLI; ports scripts/graftlint.py."""\n', []),
    ('"""A tool. No JAX counterpart: it measures kernels."""\n', []),
    ('"""Helpers. No single JAX counterpart."""\n', []),
    ('"""A module that names nothing."""\n\nX = 1\n', [1]),
    ('import os\n\n\ndef f():\n    """Not a module docstring:\n'
     '    bigdl_tpu/ops/losses.py."""\n', [1]),
    ('# a comment\n\n"""Names nothing."""\n', [3]),
]


@pytest.mark.parametrize("src, lines", DOC_CASES)
def test_module_docstring_names_the_jax_file(src, lines):
    found = _port_lint("missing-reference-docstring",
                       "bigdl_tpu_torch/ops/x.py", src)
    assert [f.line for f in found] == lines
    assert all(f.severity == "warning" for f in found)


def test_docstring_rule_is_scoped_to_the_port():
    src = '"""Names nothing."""\n'
    assert _port_lint("missing-reference-docstring", "chip_smoke.py",
                      src) == []


# --------------------------------------------------- torch's vocabulary
SYNC_SRC = '''\
import torch
import numpy as np


def decode_step(logits, ev):
    tok = logits.argmax(-1).item()  # BAD
    host = logits.cpu()  # BAD
    arr = logits.numpy()  # BAD
    rows = logits.tolist()  # BAD
    torch.cuda.synchronize()  # BAD
    ev.synchronize()  # BAD
    return tok, host, arr, rows


def setup_tables(logits):
    return logits.cpu(), logits.item()


def sample_rows(logits):
    # graftlint: disable=hidden-device-sync — the one deliberate fetch
    return logits.cpu().numpy()
'''


def _bad_lines(src):
    return {i for i, ln in enumerate(src.splitlines(), start=1)
            if "# BAD" in ln}


def test_hidden_device_sync_knows_torch_fetches():
    found = _port_lint("hidden-device-sync",
                       "bigdl_tpu_torch/serving/x.py", SYNC_SRC)
    assert {f.line for f in found} == _bad_lines(SYNC_SRC)
    assert _port_lint("hidden-device-sync", "bigdl_tpu_torch/nn/x.py",
                      SYNC_SRC) == []


TIMING_SRC = '''\
import time

import torch


def unfenced(model, x):
    t0 = time.perf_counter()
    model.train_step(x)
    return time.perf_counter() - t0  # BAD


def fenced_by_synchronize(model, x):
    t0 = time.perf_counter()
    model.train_step(x)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fenced_by_item(model, x):
    t0 = time.perf_counter()
    loss = model.train_step(x)
    loss.item()
    return time.perf_counter() - t0


def fenced_by_event(model, x, ev):
    t0 = time.perf_counter()
    model.decode_step(x)
    ev.record()
    ev.synchronize()
    return time.perf_counter() - t0


def fenced_by_copy(model, x):
    t0 = time.perf_counter()
    out = model.forward_step(x).cpu()
    out.tolist()
    return time.perf_counter() - t0, out.numpy()


def work_after_the_fence(model, x):
    t0 = time.perf_counter()
    model.train_step(x)
    torch.cuda.synchronize()
    model.train_step(x)
    return time.perf_counter() - t0  # BAD
'''


def test_unfenced_timing_knows_torch_waits():
    found = _port_lint("unfenced-timing", "bigdl_tpu_torch/utils/x.py",
                       TIMING_SRC)
    assert {f.line for f in found} == _bad_lines(TIMING_SRC)
    assert {f.line for f in _port_lint("unfenced-timing", "chip_smoke.py",
                                       TIMING_SRC)} \
        == _bad_lines(TIMING_SRC)


# ------------------------------------------------------------- mechanics
def test_suppressions():
    src = ("def f(step, loss):\n"
           "    print(loss)  # graftlint: disable=telemetry-bypass\n"
           "    # graftlint: disable=telemetry-bypass\n"
           "    print(step)\n"
           "    print(step, loss)  # graftlint: disable=unfenced-timing\n")
    found = _port_lint("telemetry-bypass", "bigdl_tpu_torch/x.py", src)
    assert [f.line for f in found] == [5]
    whole = "# graftlint: disable-file=telemetry-bypass\n" + src
    assert _port_lint("telemetry-bypass", "bigdl_tpu_torch/x.py",
                      whole) == []


def test_baseline_is_shrink_only():
    text = ('[[finding]]\nrule = "telemetry-bypass"\n'
            'path = "bigdl_tpu_torch/x.py"\ncount = 2\n'
            'reason = "a # inside"\n')
    entries = tanalysis.parse_baseline(text)
    assert tanalysis.parse_baseline(tanalysis.format_baseline(entries)) \
        == entries
    src = "def f(a):\n    print(a)\n    print(a)\n    print(a)\n"
    found = _port_lint("telemetry-bypass", "bigdl_tpu_torch/x.py", src)
    left, stale = tanalysis.apply_baseline(found, entries)
    assert [f.line for f in left] == [4] and stale == []
    left, stale = tanalysis.apply_baseline(found[:1], entries)
    assert left == [] and stale == entries


def test_each_file_is_parsed_once():
    seen = []
    tengine.PARSE_OBSERVERS.append(seen.append)
    try:
        paths = _project_paths("project_lock_discipline", "bad")
        tanalysis.run_lint(ROOT, paths=paths, project_scope=paths)
    finally:
        tengine.PARSE_OBSERVERS.remove(seen.append)
    assert sorted(seen) == sorted(paths)


# ------------------------------------------------------------------ gate
def test_the_port_lints_clean_against_its_baseline():
    findings = tanalysis.run_lint(ROOT)
    baseline = tanalysis.load_baseline(
        os.path.join(ROOT, tanalysis.BASELINE_PATH))
    left, stale = tanalysis.apply_baseline(findings, baseline)
    assert left == [], "\n".join(f.text() for f in left)
    assert stale == []
    linted = set(tanalysis.iter_python_files(ROOT))
    assert "chip_smoke.py" in linted
    assert "bigdl_tpu_torch/analysis/engine.py" in linted
    assert not any(p.startswith(("bigdl_tpu/", "scripts/", "tests/"))
                   for p in linted)


def test_cli_runs_without_jax_or_torch():
    code = ("import runpy, sys; sys.argv = ['analysis', '--format', "
            "'json']; rc = 0\n"
            "try:\n"
            "    runpy.run_module('bigdl_tpu_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'bigdl_tpu', 'torch', 'numpy')]\n"
            "print('LOADED', bad, 'RC', rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    body, tail = proc.stdout.rsplit("LOADED", 1)
    assert tail.split() == ["[]", "RC", "0"], tail
    report = json.loads(body)
    assert report["findings"] == [] and report["stale_baseline"] == []


def test_cli_lists_the_rules_and_refuses_a_missing_path():
    out = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.analysis", "--list-rules"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert {ln.split()[0] for ln in out.stdout.splitlines()} == PORTED
    bad = subprocess.run(
        [sys.executable, "-m", "bigdl_tpu_torch.analysis",
         "bigdl_tpu_torch/no_such_file.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 2


@pytest.mark.parametrize("name", ["fault_drill", "loadgen"])
def test_drill_rule_covers_the_scripts_as_the_jax_rule_does(name):
    # the JAX rule judges scripts/<name>.py; the port's, the script it
    # carries into the package
    src = "import time\n\n\ndef leg():\n    return time.time()\n"
    rule = "nondeterministic-drill"
    want = jengine.lint_source(f"scripts/{name}.py", src,
                               rules=[janalysis.RULES[rule]])
    got = _port_lint(rule, f"bigdl_tpu_torch/scripts/{name}.py", src)
    assert want and _keys(got) == _keys(want)
