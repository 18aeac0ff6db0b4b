"""metric-family-contract — one registration per family, label sets
that match it, no orphan series.

Ports bigdl_tpu/analysis/rules/metric_family_contract.py. The registry
merges idempotent re-registrations at runtime, which is exactly why
drift hides. This rule checks statically, across modules:

* **single registration** — a literal family name is registered at
  exactly one code site (f-string families like `serving_{k}_total`
  register a *pattern* site and are exempt from the uniqueness check);
* **label-set match** — every `.labels(...)` call resolvable to a
  registration (chained on it, or through the binding that stores the
  family) passes exactly the declared labelnames;
* **registered-never-bumped** — a registration whose binding is never
  referenced again anywhere in the project (and whose name is never
  fetched via `registry.get("name")`) is an orphan;
* **bumped-never-registered** — a `registry.get("name")` naming no
  registration, or a bump through a `_m_*`-conventioned attribute that
  no registration ever assigned.

Binding resolution follows the convention: families/children live in
`self._m_*` attributes or module-level names assigned straight from
`reg.counter/gauge/histogram(...)` (optionally `.labels(...)`-chained,
optionally inside a dict comprehension for keyed family maps).
"""

from __future__ import annotations

from typing import Dict, List

import ast

from bigdl_tpu_torch.analysis.engine import ProjectRule, register


@register
class MetricFamilyContract(ProjectRule):
    name = "metric-family-contract"
    severity = "error"
    description = ("metric families: single registration, matching "
                   "bump label sets, no orphan/unregistered series")

    def check_project(self, pctx):
        regs = pctx.metric_registrations
        by_name: Dict[str, List] = {}
        for r in regs:
            if r.name is not None:
                by_name.setdefault(r.name, []).append(r)
        by_binding = {r.binding: r for r in regs
                      if r.binding is not None}
        # ---- label sets on chained .labels(...) ------------------------
        for r in regs:
            if r.chained_labels is None or r.labelnames is None:
                continue
            yield from self._check_labels(
                pctx, r, r.chained_labels, r.path)
        # ---- bumps resolved through bindings ---------------------------
        bumped_bindings = set()
        for b in pctx.metric_bumps:
            if b.binding in by_binding:
                bumped_bindings.add(b.binding)
                r = by_binding[b.binding]
                if b.method == "labels" or b.label_names is not None:
                    if r.chained_labels is not None:
                        # binding holds a CHILD (labels already applied
                        # at registration) — .labels() on it re-labels
                        # a child, which raises at runtime
                        yield self.finding(
                            pctx.files[b.path], b.node,
                            f"binding {b.base_name!r} holds a labeled "
                            f"child of {r.name or r.pattern!r} — "
                            f".labels(...) on a child is a runtime "
                            f"error; call it on the family")
                    elif r.labelnames is not None \
                            and b.label_names is not None \
                            and set(b.label_names) != set(r.labelnames):
                        yield self.finding(
                            pctx.files[b.path], b.node,
                            f"bump labels {sorted(b.label_names)} do "
                            f"not match family "
                            f"{r.name or r.pattern!r} labelnames "
                            f"{sorted(r.labelnames)} (registered at "
                            f"{r.path}:{r.node.lineno})")
            elif b.binding is not None \
                    and b.base_name.startswith("_m_"):
                # the `_m_*` convention marks metric bindings — a bump
                # through one with no registration anywhere is a
                # family nobody ever created
                yield self.finding(
                    pctx.files[b.path], b.node,
                    f"bump through metric binding {b.base_name!r} but "
                    f"no registration assigns it — register the family "
                    f"or drop the bump (bumped-never-registered)")
        # ---- single registration per literal family name --------------
        for name, sites in sorted(by_name.items()):
            # the canonical owner is the site whose binding actually
            # gets bumped, then any bound site — the stray duplicate
            # is the re-register nobody feeds
            sites = sorted(sites, key=lambda r: (
                r.binding not in bumped_bindings,
                r.binding is None, r.path, r.node.lineno))
            for dup in sites[1:]:
                first = sites[0]
                yield self.finding(
                    pctx.files[dup.path], dup.node,
                    f"metric family {name!r} is also registered at "
                    f"{first.path}:{first.node.lineno} — exactly one "
                    f"registration site per family (share the binding "
                    f"or registry.get() it)")
        # ---- registry.get("name") by-name references -------------------
        named_refs = set()
        for ref in pctx.metric_name_refs:
            if any(r.matches(ref.name) for r in regs):
                named_refs.add(ref.name)
                continue
            yield self.finding(
                pctx.files[ref.path], ref.node,
                f"registry.get({ref.name!r}) names a family no call "
                f"site registers (bumped-never-registered)")
        # ---- registered-never-bumped -----------------------------------
        for r in regs:
            if r.inline_bumped:
                continue
            if r.name is not None and r.name in named_refs:
                continue
            if r.binding is not None:
                if r.binding in bumped_bindings:
                    continue
                if self._binding_referenced(pctx, r):
                    continue
            yield self.finding(
                pctx.files[r.path], r.node,
                f"metric family {r.name or r.pattern!r} is registered "
                f"but never bumped or read anywhere in the project — "
                f"wire it or cull it (registered-never-bumped)")

    def _check_labels(self, pctx, r, labels_call, path):
        if any(kw.arg is None for kw in labels_call.keywords):
            return
        passed = {kw.arg for kw in labels_call.keywords}
        if passed != set(r.labelnames):
            yield self.finding(
                pctx.files[path], labels_call,
                f"labels {sorted(passed)} do not match family "
                f"{r.name or r.pattern!r} labelnames "
                f"{sorted(r.labelnames)}")

    @staticmethod
    def _binding_referenced(pctx, r) -> bool:
        """True when the registration's binding is loaded anywhere
        beyond its defining assignment — a property returning it, a
        health() read, a handoff into another object all count as the
        family being wired. Binding keys are 'path::name' (module
        scope) or 'path:Class.attr' (see project._binding_of)."""
        if "::" in r.binding:
            name = r.binding.split("::", 1)[1]
            ctx = pctx.files[r.path]
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Name) and node.id == name \
                        and isinstance(node.ctx, ast.Load):
                    return True
            return False
        attr = r.binding.rsplit(".", 1)[1]
        for ctx in pctx.files.values():
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.Attribute) \
                        and node.attr == attr \
                        and isinstance(node.ctx, ast.Load):
                    return True
        return False
