"""lock-discipline — state shared between a background thread and the
main path is accessed under a lock on both sides.

Ports bigdl_tpu/analysis/rules/lock_discipline.py. Background threads
share attributes with hot paths: the serving engine's step watchdog,
the asynchronous checkpoint writer, the dataset prefetch workers, and
the flight recorder's event-log listener (called from whatever thread
emits). A `self.x` written from any of those and also touched by a
main-path method is a race unless both sides hold a lock.

Detection (lightweight, class-scoped):

* thread entrypoints: a method handed to `threading.Thread(target=
  self.m)`, subscribed via `add_listener(self.m)`, or a local closure
  passed as a Thread target inside a method (the watchdog's
  `boxed()`/`work()` pattern) — plus every class method transitively
  called from one;
* thread-side WRITES: `self.x = ...` / `self.x += ...` or a mutating
  method call (`self.x.append(...)`, `.update`, `.put`, ...) inside a
  thread-side function, excluding attributes that are themselves
  synchronization objects (`Lock`/`Event`/`Queue`/...);
* both the thread-side write and every main-path access (any method
  except `__init__`, which runs before the thread exists) of such an
  attribute must sit inside a `with self.<lock>:` region — directly,
  or in a helper whose every call site is inside one (the flight
  recorder's `_dump` pattern).

A racy-by-design access carries an inline suppression naming why it is
safe (GIL-atomic single read, monotonic flag, ...) — the standard
`# graftlint: disable=lock-discipline` + a why.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Set, Tuple

from bigdl_tpu_torch.analysis.engine import ProjectRule, register
from bigdl_tpu_torch.analysis.project import _MUTATORS, ThreadClass


@register
class LockDiscipline(ProjectRule):
    name = "lock-discipline"
    severity = "error"
    description = ("thread-shared attribute accessed outside a lock "
                   "region on the thread or main path")

    def check_project(self, pctx):
        for tc in pctx.thread_classes:
            yield from self._check_class(pctx, tc)

    def _check_class(self, pctx, tc: ThreadClass):
        ctx = pctx.files[tc.path]
        thread_fns: List[Tuple[str, ast.FunctionDef]] = []
        for m in tc.entry_methods:
            thread_fns.append((m, tc.methods[m]))
        # closure entries: only the closure defs run on the thread —
        # the HOST method stays main-path (it starts/joins the thread)
        # with the closure subtrees carved out of its scan
        closure_nodes: Dict[str, set] = {}
        for host, closures in tc.closure_entries:
            for c in closures:
                thread_fns.append((f"{host}.{c.name}", c))
                closure_nodes.setdefault(host, set()).update(
                    ast.walk(c))
        # expand through self-calls: a method only the thread reaches
        # runs on the thread
        reachable = {n for n, _ in thread_fns}
        frontier = [fn for _, fn in thread_fns]
        while frontier:
            fn = frontier.pop()
            for sub in ast.walk(fn):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == "self" \
                        and sub.func.attr in tc.methods \
                        and sub.func.attr not in reachable:
                    reachable.add(sub.func.attr)
                    thread_fns.append((sub.func.attr,
                                       tc.methods[sub.func.attr]))
                    frontier.append(tc.methods[sub.func.attr])
        locked_methods = self._effectively_locked(ctx, tc)

        def is_locked(node, fn_name: str, fn) -> bool:
            if fn_name.split(".")[-1] in locked_methods:
                return True
            return self._under_lock(ctx, node, fn, tc)

        # ---- thread-side writes ---------------------------------------
        writes: Dict[str, List[Tuple[str, ast.AST, bool]]] = {}
        for fname, fn in thread_fns:
            for attr, node in self._attr_writes(fn):
                if attr in tc.sync_attrs:
                    continue
                writes.setdefault(attr, []).append(
                    (fname, node, is_locked(node, fname, fn)))
        if not writes:
            return
        for attr, sites in sorted(writes.items()):
            for fname, node, locked in sites:
                if not locked:
                    yield self.finding(
                        ctx, node,
                        f"`self.{attr}` is written on the "
                        f"thread side ({fname}) outside a lock region "
                        f"— wrap in `with self.<lock>:` or suppress "
                        f"with the reason it is safe")
        # ---- main-path accesses of thread-written attrs ----------------
        # thread-side methods are the entrypoints + everything
        # reachable from them via self-calls; closure HOSTS are not in
        # this set (their dotted "host.closure" names drop out here)
        thread_methods = {n for n, _ in thread_fns if "." not in n}
        for mname, m in sorted(tc.methods.items()):
            if mname == "__init__" or mname in thread_methods:
                continue
            excluded = closure_nodes.get(mname, set())
            for attr, node in self._attr_accesses(m):
                if node in excluded:
                    continue    # closure body: already thread-scanned
                if attr not in writes:
                    continue
                if is_locked(node, mname, m):
                    continue
                wname, wnode, _ = writes[attr][0]
                yield self.finding(
                    ctx, node,
                    f"`self.{attr}` is written from thread entrypoint "
                    f"{wname} (line {wnode.lineno}) and accessed here "
                    f"on the main path outside a lock region — take "
                    f"the same lock on both sides or suppress with the "
                    f"reason it is safe")

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _self_attr(node):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self":
            return node.attr
        return None

    def _attr_writes(self, fn):
        """(attr, node) for self.<attr> stores / augmented stores /
        mutating method calls inside `fn` (nested defs included — they
        run on the same thread)."""
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    attr = self._self_attr(t)
                    if attr is not None:
                        yield attr, t
                    elif isinstance(t, ast.Subscript):
                        attr = self._self_attr(t.value)
                        if attr is not None:
                            yield attr, t
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _MUTATORS:
                attr = self._self_attr(node.func.value)
                if attr is not None:
                    yield attr, node

    def _attr_accesses(self, fn):
        for node in ast.walk(fn):
            attr = self._self_attr(node)
            if attr is not None:
                yield attr, node

    def _under_lock(self, ctx, node, fn, tc: ThreadClass) -> bool:
        """Ancestor `with self.<lock>:` between `node` and `fn`."""
        cur = ctx.parent(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    expr = item.context_expr
                    attr = self._self_attr(expr)
                    if attr is not None and (
                            attr in tc.lock_attrs
                            or "lock" in attr.lower()):
                        return True
            cur = ctx.parent(cur)
        return False

    def _effectively_locked(self, ctx, tc: ThreadClass) -> Set[str]:
        """Methods whose EVERY in-class call site is inside a lock
        region (directly or in another effectively-locked method) —
        their bodies inherit the lock (FlightRecorder._dump)."""
        # call sites: method -> [(caller, call node)]
        sites: Dict[str, List[Tuple[str, ast.Call]]] = {}
        for caller, m in tc.methods.items():
            for node in ast.walk(m):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id == "self" \
                        and node.func.attr in tc.methods:
                    sites.setdefault(node.func.attr, []).append(
                        (caller, node))
        locked: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for m, calls in sites.items():
                if m in locked or not calls:
                    continue
                if all(caller in locked
                       or self._under_lock(ctx, node,
                                           tc.methods[caller], tc)
                       for caller, node in calls):
                    locked.add(m)
                    changed = True
        return locked
