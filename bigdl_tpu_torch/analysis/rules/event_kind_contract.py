"""event-kind-contract — every emitted/consumed event kind must exist
in the machine-readable `EVENT_KINDS` registry (obs/events.py).

Ports bigdl_tpu/analysis/rules/event_kind_contract.py. Committed code
is a contract: `obs/journey.py`, the flight recorder's trigger set and
the drill assertions consume kinds by string literal, and a
producer/consumer drifting apart fails silently. This rule pins both
sides to the registry:

* every `emit_event("<kind>", ...)` / `<log>.emit("<kind>", ...)` with
  a literal kind must name a registered kind;
* the statically visible keyword fields at the call site must be
  declared (required or optional) for that kind, and — when the call
  has no `**splat` hiding fields — every required field must be
  passed;
* every consumer-side kind literal (an `.events("<kind>")` filter, a
  `rec["kind"] == "<kind>"` / `kind in (...)` comparison) must
  reference a producible (registered) kind.

Metric-family snapshots share the "kind" key (`fam["kind"] ==
"histogram"`), so the metric kind names are a documented carve-out of
the consumer check (see project.METRIC_FAMILY_KINDS).
"""

from __future__ import annotations

from bigdl_tpu_torch.analysis.engine import ProjectRule, register
from bigdl_tpu_torch.analysis.project import METRIC_FAMILY_KINDS


@register
class EventKindContract(ProjectRule):
    name = "event-kind-contract"
    severity = "error"
    description = ("emit_event kinds/fields and consumer kind literals "
                   "must match the obs EVENT_KINDS registry")

    def check_project(self, pctx):
        reg = pctx.event_registry
        if reg is None:
            return            # no registry in scope (bare subtree)
        for extra in pctx.event_registries[1:]:
            yield self.finding(
                pctx.files[extra.path], _at(extra.path, extra.line),
                f"duplicate EVENT_KINDS registry (the authoritative "
                f"one is {reg.path}:{reg.line}) — there is exactly one "
                f"source of truth for event kinds")
        for p in pctx.event_producers:
            ctx = pctx.files[p.path]
            if p.kind not in reg.kinds:
                yield self.finding(
                    ctx, p.node,
                    f"emit_event kind {p.kind!r} is not registered in "
                    f"{reg.path}::EVENT_KINDS — document it (required/"
                    f"optional fields) before emitting it")
                continue
            req, opt = reg.kinds[p.kind]
            if req is None:
                continue      # non-literal registry entry: waived
            allowed = set(req) | set(opt or ())
            for field in p.fields:
                if field not in allowed:
                    yield self.finding(
                        ctx, p.node,
                        f"emit_event({p.kind!r}) passes undeclared "
                        f"field {field!r} — add it to the kind's "
                        f"required/optional set in EVENT_KINDS or drop "
                        f"it")
            if not p.has_splat:
                missing = [f for f in req if f not in p.fields]
                if missing:
                    yield self.finding(
                        ctx, p.node,
                        f"emit_event({p.kind!r}) misses required "
                        f"field(s) {missing} — consumers (journeys, "
                        f"obs_report, drills) rely on them")
        for c in pctx.event_consumers:
            if c.kind in reg.kinds or c.kind in METRIC_FAMILY_KINDS:
                continue
            yield self.finding(
                pctx.files[c.path], c.node,
                f"consumer references event kind {c.kind!r} that no "
                f"producer can emit (not in {reg.path}::EVENT_KINDS) — "
                f"the filter/branch is dead")


class _at:
    """Minimal lineno/col carrier for findings not tied to an AST
    node we kept around."""

    def __init__(self, path: str, line: int, col: int = 0):
        self.lineno = line
        self.col_offset = col
