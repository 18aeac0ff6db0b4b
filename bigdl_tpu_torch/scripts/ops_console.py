"""Fleet ops console — a terminal dashboard over the live
SLO plane.

Ports scripts/ops_console.py over bigdl_tpu_torch.obs; its digests come
from the port's obs_report, imported as a sibling module. It renders
text from a file or a scrape endpoint: it runs nothing on a device.

Renders pool health, per-engine / per-layout SLO compliance, firing
alerts, and recent incidents as one text frame. Two sources:

* **JSONL event log** (the `BIGDL_OBS_EVENTS` sink / an explicit
  `EventLog(path=...)`): the frame is a PURE function of the parsed
  events — replaying the same file twice prints byte-identical
  frames (the deterministic mode the tests pin). `--follow` tails the
  file of a LIVE run (e.g. a loadgen or serve_lm process writing the
  sink) and redraws every `--interval` seconds.
* **Scrape endpoint** (`--url http://host:port`, obs/exposition.py):
  polls `/health` (+ `/metrics` for the pool gauges) and renders the
  JSON ops view — the live-fleet mode when only the HTTP surface is
  reachable.

Usage:
    # deterministic replay (one frame, byte-identical run to run):
    python -m bigdl_tpu_torch.scripts.ops_console /tmp/run.jsonl

    # watch a live loadgen run through its JSONL sink:
    BIGDL_OBS_EVENTS=/tmp/run.jsonl \
        python -m bigdl_tpu_torch.scripts.loadgen --requests 64 \
        --engines 2 ... &
    python -m bigdl_tpu_torch.scripts.ops_console /tmp/run.jsonl --follow

    # watch through a scrape endpoint (obs.ScrapeServer):
    python -m bigdl_tpu_torch.scripts.ops_console \
        --url http://127.0.0.1:8080 --follow
"""

from __future__ import annotations

# graftlint: disable-file=telemetry-bypass — a CLI owns its stdout

import argparse
import json
import sys
import time
from typing import List, Optional

# the console reuses the report's summarize() digests (SLO, alerts,
# incidents), so the two surfaces can never disagree about a run
from bigdl_tpu_torch.scripts import obs_report

WIDTH = 78


def _rule(title: str) -> str:
    pad = WIDTH - len(title) - 4
    return f"── {title} " + "─" * max(pad, 0)


def _kv_rows(rows: List[tuple], indent: str = "  ") -> List[str]:
    if not rows:
        return [indent + "(none)"]
    w = max(len(str(k)) for k, _ in rows)
    return [f"{indent}{str(k):<{w}}  {v}" for k, v in rows]


def _fmt_s(v) -> str:
    return "-" if v is None else f"{v:.4g}s"


# --------------------------------------------------------- event frames

def render_frame(events: List[dict]) -> str:
    """One dashboard frame from an event list — deterministic: no
    wall-clock reads, no environment, output a pure function of the
    events (the byte-identity surface)."""
    s = obs_report.summarize(events)
    lines: List[str] = []
    ts = [e["ts"] for e in events
          if isinstance(e.get("ts"), (int, float))]
    span = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    lines.append("═" * WIDTH)
    lines.append(f" fleet ops console — {len(events)} events over "
                 f"{round(span, 3)}s")
    lines.append("═" * WIDTH)

    # ---- pool health ------------------------------------------------
    lines.append(_rule("pool"))
    term = [e for e in events if e.get("kind") == "request_terminal"]
    engines = sorted({e.get("engine", "?") for e in term}
                     | {e.get("engine") for e in events
                        if e.get("kind") in ("engine_added",
                                             "engine_degraded",
                                             "engine_drain")
                        and e.get("engine")})
    degraded = {e.get("engine") for e in events
                if e.get("kind") == "engine_degraded"}
    drained = {e.get("engine") for e in events
               if e.get("kind") == "engine_removed"}
    rows = []
    for eng in engines:
        evs = [e for e in term if e.get("engine", "?") == eng]
        state = ("DEGRADED" if eng in degraded
                 else "removed" if eng in drained else "serving")
        tp = evs[-1].get("tp") if evs else None
        role = evs[-1].get("role") if evs else None
        tag = "" if tp in (None, 1) else f" tp={tp}"
        tag += f" role={role}" if role and role != "both" else ""
        done = sum(1 for e in evs if e.get("status") == "done")
        toks = sum(e.get("tokens", 0) for e in evs
                   if e.get("status") == "done")
        rows.append((eng, f"{state}{tag}  {done}/{len(evs)} done, "
                          f"{toks} tok"))
    added = sum(1 for e in events if e.get("kind") == "engine_added")
    removed = sum(1 for e in events
                  if e.get("kind") == "engine_removed")
    if added or removed:
        rows.append(("pool churn", f"+{added} engines, -{removed}"))
    lines.extend(_kv_rows(rows))

    # ---- SLO compliance ---------------------------------------------
    lines.append(_rule("SLO"))
    slo = s.get("slo")
    if slo:
        def fmt(d):
            return (f"done {d['done']}/{d['requests']}  ttft p50/p99 "
                    f"{_fmt_s(d['ttft_p50_s'])}/{_fmt_s(d['ttft_p99_s'])}"
                    f"  latency p99 {_fmt_s(d['latency_p99_s'])}  "
                    f"shed/exp/poison {d['shed_rate']}"
                    f"/{d['expired_rate']}/{d['poisoned_rate']}")
        rows = [("fleet", fmt(slo["fleet"]))]
        rows += [(eng, fmt(d))
                 for eng, d in slo["per_engine"].items()]
        rows += [(layout, fmt(d))
                 for layout, d in slo.get("per_layout", {}).items()]
        lines.extend(_kv_rows(rows))
    else:
        lines.extend(_kv_rows([]))

    # ---- tenants ----------------------------------------------------
    tn = s.get("tenants")
    if tn:
        lines.append(_rule("tenants"))
        rows = []
        for t, d in tn.items():
            thr = d.get("throttled", {})
            thr_txt = ("none" if not thr else
                       " ".join(f"{k}={n}" for k, n in thr.items()))
            if d["requests"]:
                rows.append((t, f"done {d['done']}/{d['requests']}  "
                                f"p99 {_fmt_s(d.get('latency_p99_s'))}"
                                f"  throttled {thr_txt}"))
            else:
                rows.append((t, f"no terminals  throttled {thr_txt}"))
        lines.extend(_kv_rows(rows))

    # ---- alerts -----------------------------------------------------
    lines.append(_rule("alerts"))
    al = s.get("alerts")
    if al:
        rows = []
        for obj, o in al["objectives"].items():
            comp = ("-" if o["compliant_frac"] is None
                    else f"{o['compliant_frac']:.2%}")
            rows.append((obj, f"{o['alerts']} alert(s), "
                              f"{o['time_firing_s']}s firing, "
                              f"compliant {comp}"))
        for rec in al["timeline"]:
            state = (f"resolved after {rec['firing_s']}s"
                     if rec["firing_s"] is not None
                     else "** STILL FIRING **")
            rows.append((f"{rec['alert']}",
                         f"fired t={rec['fired_ts']} value "
                         f"{rec['value']} > {rec['target']} "
                         f"({rec['rule_kind']}) — {state}"))
        lines.extend(_kv_rows(rows))
    else:
        lines.extend(_kv_rows([]))

    # ---- kv tier ----------------------------------------------------
    kt = s.get("kv_tier")
    if kt:
        lines.append(_rule("kv tier"))
        rows = [("spill / re-admit",
                 f"{kt['spilled_blocks']} blocks out, "
                 f"{kt['readmitted_blocks']} back")]
        if "hit_source" in kt:
            hs = kt["hit_source"]
            rows.append(("hit source",
                         f"device {hs['device']} / host {hs['host']}"
                         f" / miss {hs['miss']}"))
        for path in kt.get("migration_paths", []):
            rows.append((f"{path['source']} -> {path['target']}",
                         f"migrated {path['blocks']} blocks "
                         f"({path['chains']} chains)"))
        for key, v in sorted(kt.get("tier_blocks_in_use",
                                    {}).items()):
            rows.append((f"in use [{key}]", v))
        lines.extend(_kv_rows(rows))

    # ---- incidents --------------------------------------------------
    lines.append(_rule("incidents"))
    inc = s.get("incidents")
    if inc:
        rows = [(b["bundle"], f"{b['incident']} @ {b['component']} "
                              f"(trigger {b['trigger_kind']})")
                for b in inc["bundles"]]
        lines.extend(_kv_rows(rows))
    else:
        lines.extend(_kv_rows([]))
    lines.append("═" * WIDTH)
    return "\n".join(lines)


# ------------------------------------------------------- scrape frames

def render_scrape_frame(health: dict, metrics_text: str) -> str:
    """One frame from a scrape endpoint's /health JSON + /metrics
    text (obs/exposition.py)."""
    lines = ["═" * WIDTH, " fleet ops console — scrape endpoint",
             "═" * WIDTH, _rule("endpoint")]
    samp = health.get("sampler") or {}
    lines.extend(_kv_rows([
        ("scrapes", health.get("scrapes")),
        ("samples", samp.get("samples")),
        ("last sample t", samp.get("last_sample_t")),
    ]))
    lines.append(_rule("objectives"))
    rows = [(o["objective"],
             f"value {o['value']} vs target {o['target']} — "
             + ("OK" if o["ok"] else "VIOLATED"))
            for o in health.get("objectives", [])]
    lines.extend(_kv_rows(rows))
    lines.append(_rule("alerts"))
    rows = [(a["alert"], f"{a['state']}  value {a['value']} target "
                         f"{a['target']} ({a['kind']})")
            for a in health.get("alerts", [])]
    lines.extend(_kv_rows(rows))
    lines.append(_rule("pool gauges"))
    rows = []
    for ln in metrics_text.splitlines():
        if ln.startswith(("router_pool_size",
                          "serving_kv_pool_blocks_in_use",
                          "serving_kv_tier_blocks_in_use",
                          "serving_tp_shards")):
            name, _, val = ln.rpartition(" ")
            rows.append((name, val))
    lines.extend(_kv_rows(rows))
    lines.append("═" * WIDTH)
    return "\n".join(lines)


def _fetch(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=5.0) as resp:
        return resp.read()


def _one_frame(args) -> Optional[str]:
    if args.url:
        health = json.loads(_fetch(args.url.rstrip("/") + "/health"))
        metrics = _fetch(args.url.rstrip("/") + "/metrics").decode()
        return render_scrape_frame(health, metrics)
    from bigdl_tpu_torch.obs.events import read_jsonl

    events = read_jsonl(args.path)
    if not events:
        return None
    return render_frame(events)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", nargs="?", default=None,
                    help="JSONL event file (BIGDL_OBS_EVENTS sink)")
    ap.add_argument("--url", default=None,
                    help="scrape endpoint base URL instead of a file "
                         "(obs.ScrapeServer: /health + /metrics)")
    ap.add_argument("--follow", action="store_true",
                    help="redraw every --interval seconds (live run)")
    ap.add_argument("--interval", type=float, default=2.0)
    args = ap.parse_args(argv)
    if (args.path is None) == (args.url is None):
        print("ops-console: pass a JSONL path OR --url", file=sys.stderr)
        return 2
    if not args.follow:
        try:
            frame = _one_frame(args)
        except OSError as e:
            print(f"ops-console: cannot read source: {e}",
                  file=sys.stderr)
            return 2
        if frame is None:
            print(f"ops-console: no events in {args.path}",
                  file=sys.stderr)
            return 2
        print(frame)
        return 0
    try:
        while True:
            try:
                frame = _one_frame(args)
            except OSError as e:
                frame = f"(source unavailable: {e})"
            # clear + home, then the frame — a cheap live dashboard
            sys.stdout.write("\x1b[2J\x1b[H"
                             + (frame or "(no events yet)") + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
