"""ProjectContext — the shared pass-1 index behind the port's
cross-module lint rules.

Ports bigdl_tpu/analysis/project.py, less its jit indexes (the traced
roots, and the donated-argument index that only the JAX-tracing rules
read). Per-file rules see one `FileContext` at a time; the contracts
here span modules: event kinds produced in `serving/engine.py` are
consumed by `obs/journey.py` and the flight-recorder trigger set,
metric families registered in one module are bumped from others, and
background threads share attributes with hot paths. `ProjectContext`
is built ONCE per lint run (pass 1) from the already-parsed
`FileContext`s — no file is ever parsed twice — and pass 2 hands it to
every `ProjectRule`.

Indexes collected in one walk per file:

* `files`            — repo-relative path → FileContext (module index)
* `event_registry`   — the machine-readable `EVENT_KINDS` dict
                       (obs/events.py, or a fixture tree's own copy)
* `event_producers`  — `emit_event("kind", ...)` / `<log>.emit("kind",
                       ...)` call sites with their visible keyword set
* `event_consumers`  — kind references on the read side: `.events("k")`
                       filters and `<rec>["kind"] == "k"`-shaped
                       comparisons/memberships
* `metric_registrations` / `metric_bumps` / `metric_name_refs`
                     — registry `counter/gauge/histogram` calls with
                       name + labelnames + the binding that holds the
                       family, `.labels/.inc/.set/.observe` bump sites
                       resolved back to their binding, and
                       `registry.get("name")` by-name references
* `thread_classes`   — classes that start a background thread
                       (`threading.Thread(target=self.m)`, an event-log
                       `add_listener(self.m)` subscription, or a
                       local-closure target inside a method) with their
                       lock/synchronized attributes and method table

Everything is pure stdlib AST bookkeeping; the heavy semantic judgement
lives in the rules (`analysis/rules/*_contract.py` etc.).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

from bigdl_tpu_torch.analysis.astutil import (call_name, dotted,
                                              last_segment)
from bigdl_tpu_torch.analysis.engine import FileContext

# observers called with the ProjectContext each time one is BUILT — a
# test hooks this to pin "built once per run"
BUILD_OBSERVERS: List[Callable[["ProjectContext"], None]] = []

# metric-family snapshots share the "kind" key with event records
# (`fam["kind"] == "histogram"` in obs_report/provenance) — these
# literals are a deliberate carve-out of the event-kind consumer check
METRIC_FAMILY_KINDS = frozenset(
    {"counter", "gauge", "histogram", "untyped"})

_REGISTRY_RECEIVERS = ("reg", "registry")
_BUMP_METHODS = frozenset({"inc", "dec", "set", "observe", "quantile"})
# attribute methods that MUTATE their receiver (shared-state writes for
# the lock-discipline rule)
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "remove", "discard", "clear", "update", "add",
    "setdefault", "popitem", "sort", "reverse", "put", "put_nowait"})
# constructors whose instances are themselves synchronization points —
# writes through them need no extra lock
_SYNC_TYPES = frozenset({
    "Lock", "RLock", "Event", "Condition", "Semaphore",
    "BoundedSemaphore", "Barrier", "Queue", "SimpleQueue", "LifoQueue",
    "PriorityQueue"})
_LOCK_TYPES = frozenset({"Lock", "RLock"})


@dataclasses.dataclass(frozen=True)
class EventProducer:
    path: str
    node: ast.Call
    kind: str
    fields: Tuple[str, ...]       # visible keyword names
    has_splat: bool               # **kwargs present → fields incomplete


@dataclasses.dataclass(frozen=True)
class EventConsumer:
    path: str
    node: ast.AST
    kind: str
    form: str                     # "events-call" | "kind-compare"


@dataclasses.dataclass(frozen=True)
class EventRegistry:
    path: str
    line: int
    # kind → (required, optional) — None tuples mean the entry was not
    # a literal dict, so field checks are waived for that kind
    kinds: Dict[str, Tuple[Optional[Tuple[str, ...]],
                           Optional[Tuple[str, ...]]]]


@dataclasses.dataclass(frozen=True)
class MetricRegistration:
    path: str
    node: ast.Call
    name: Optional[str]           # literal family name, None if dynamic
    pattern: Optional[str]        # f-string name with '*' placeholders
    kind: str                     # counter | gauge | histogram
    labelnames: Optional[Tuple[str, ...]]  # None = unresolvable
    binding: Optional[str]        # "ClassName.attr" / "module:name"
    chained_labels: Optional[ast.Call]  # .labels(...) chained on reg
    inline_bumped: bool           # chain ends in .inc/.observe/...

    def matches(self, name: str) -> bool:
        if self.name is not None:
            return self.name == name
        if self.pattern is None:
            return False
        parts = self.pattern.split("*")
        if not name.startswith(parts[0]) or not name.endswith(parts[-1]):
            return False
        return len(name) >= sum(len(p) for p in parts)


@dataclasses.dataclass(frozen=True)
class MetricBump:
    path: str
    node: ast.Call
    binding: Optional[str]
    base_name: str                # receiver attr/name for diagnostics
    method: str
    label_names: Optional[Tuple[str, ...]]  # when a .labels() in chain


@dataclasses.dataclass(frozen=True)
class MetricNameRef:
    path: str
    node: ast.Call
    name: str


@dataclasses.dataclass
class ThreadClass:
    path: str
    node: ast.ClassDef
    methods: Dict[str, ast.FunctionDef]
    # entrypoint method names (Thread target / add_listener callback)
    entry_methods: List[str]
    # (enclosing method name, local thread-fn defs incl. helpers)
    closure_entries: List[Tuple[str, List[ast.FunctionDef]]]
    lock_attrs: Set[str]          # self.X = threading.(R)Lock()
    sync_attrs: Set[str]          # self.X = Queue()/Event()/... (+locks)


class ProjectContext:
    """One parse of the tree, shared by every cross-module rule."""

    def __init__(self, root: str, files: Dict[str, FileContext]):
        self.root = root
        self.files = dict(sorted(files.items()))
        self.event_registries: List[EventRegistry] = []
        self.event_producers: List[EventProducer] = []
        self.event_consumers: List[EventConsumer] = []
        self.metric_registrations: List[MetricRegistration] = []
        self.metric_bumps: List[MetricBump] = []
        self.metric_name_refs: List[MetricNameRef] = []
        self.thread_classes: List[ThreadClass] = []
        for path, ctx in self.files.items():
            self._index_file(path, ctx)
        for fn in BUILD_OBSERVERS:
            fn(self)

    @property
    def event_registry(self) -> Optional[EventRegistry]:
        """The authoritative EVENT_KINDS registry (first by path)."""
        return self.event_registries[0] if self.event_registries else None

    # ----------------------------------------------------------- indexing
    def _index_file(self, path: str, ctx: FileContext) -> None:
        kind_compares: List[ast.Compare] = []
        # scopes that alias an event record's kind into a local
        # (`kind = e.get("kind")`): only inside those do comparisons
        # on a bare `kind` name count as event-kind consumers — scopes
        # with their own `kind` locals (serializer "__kind__" specs,
        # lint internals) stay out
        alias_scopes: Set[ast.AST] = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._index_event_registry(path, node)
                if isinstance(node, ast.Assign) \
                        and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id == "kind" \
                        and _is_kind_expr(node.value):
                    _link_parents(ctx)
                    alias_scopes.add(_enclosing_scope(node))
            elif isinstance(node, ast.Call):
                self._index_call(path, ctx, node)
            elif isinstance(node, ast.Compare):
                kind_compares.append(node)
            elif isinstance(node, ast.ClassDef):
                tc = _thread_class(path, node)
                if tc is not None:
                    self.thread_classes.append(tc)
        if kind_compares:
            _link_parents(ctx)
        for node in kind_compares:
            self._index_kind_compare(path, node, alias_scopes)

    def _index_event_registry(self, path: str, node) -> None:
        target = node.target if isinstance(node, ast.AnnAssign) \
            else (node.targets[0] if len(node.targets) == 1 else None)
        if not isinstance(target, ast.Name) \
                or target.id != "EVENT_KINDS" \
                or not isinstance(node.value, ast.Dict):
            return
        kinds: Dict[str, Tuple[Optional[Tuple[str, ...]],
                               Optional[Tuple[str, ...]]]] = {}
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            req = opt = None
            if isinstance(v, ast.Dict):
                spec = {kk.value: vv for kk, vv in zip(v.keys, v.values)
                        if isinstance(kk, ast.Constant)}
                req = _str_seq(spec.get("required"))
                opt = _str_seq(spec.get("optional"))
            kinds[k.value] = (req, opt)
        self.event_registries.append(EventRegistry(
            path, node.lineno, kinds))
        self.event_registries.sort(key=lambda r: r.path)

    def _index_call(self, path: str, ctx: FileContext,
                    node: ast.Call) -> None:
        name = call_name(node)
        seg = last_segment(name)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        # --- event producers -------------------------------------------
        if (seg == "emit_event" or (attr == "emit"
                                    and _is_event_log(node.func.value))) \
                and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            self.event_producers.append(EventProducer(
                path, node, node.args[0].value,
                tuple(kw.arg for kw in node.keywords
                      if kw.arg is not None),
                any(kw.arg is None for kw in node.keywords)))
        # --- event consumers: EventLog.events("kind", ...) -------------
        if attr == "events":
            kind_arg = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "kind":
                    kind_arg = kw.value
            if isinstance(kind_arg, ast.Constant) \
                    and isinstance(kind_arg.value, str):
                self.event_consumers.append(EventConsumer(
                    path, kind_arg, kind_arg.value, "events-call"))
        # --- metric registrations --------------------------------------
        if attr in ("counter", "gauge", "histogram") \
                and _is_registry(node.func.value):
            self.metric_registrations.append(
                _metric_registration(path, ctx, node, attr))
        # --- metric by-name references ---------------------------------
        if attr == "get" and _is_registry(node.func.value) \
                and len(node.args) == 1 \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            self.metric_name_refs.append(MetricNameRef(
                path, node, node.args[0].value))
        # --- metric bumps ----------------------------------------------
        if attr in _BUMP_METHODS or attr == "labels":
            bump = _metric_bump(path, ctx, node, attr)
            if bump is not None:
                self.metric_bumps.append(bump)

    def _index_kind_compare(self, path: str, node: ast.Compare,
                            alias_scopes) -> None:
        """`<rec>.get("kind") == "x"` / `kind in ("a", "b")`-shaped
        consumer references (both operand orders). The bare-`kind`
        form only counts inside a scope that aliases
        `kind = <rec>["kind"]` (see _index_file)."""
        if len(node.ops) != 1 or not isinstance(
                node.ops[0], (ast.Eq, ast.NotEq, ast.In, ast.NotIn)):
            return
        sides = [node.left, node.comparators[0]]

        def counts(s):
            if isinstance(s, ast.Name):
                return _is_kind_expr(s) \
                    and _enclosing_scope(s) in alias_scopes
            return _is_kind_expr(s)

        if not any(counts(s) for s in sides):
            return
        for side in sides:
            for lit in _str_literals(side):
                self.event_consumers.append(EventConsumer(
                    path, side, lit, "kind-compare"))


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def _str_seq(node) -> Optional[Tuple[str, ...]]:
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = tuple(e.value for e in node.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))
        if len(out) == len(node.elts):
            return out
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    return None


def _str_literals(node) -> List[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        out = []
        for e in node.elts:
            if isinstance(e, ast.Constant) and isinstance(e.value, str):
                out.append(e.value)
        return out
    return []


def _is_kind_expr(node) -> bool:
    """An expression reading the "kind" key: `x["kind"]`,
    `x.get("kind")`, or a bare variable literally named `kind`."""
    if isinstance(node, ast.Name) and node.id == "kind":
        return True
    if isinstance(node, ast.Subscript) \
            and isinstance(node.slice, ast.Constant) \
            and node.slice.value == "kind":
        return True
    if isinstance(node, ast.Call) \
            and isinstance(node.func, ast.Attribute) \
            and node.func.attr == "get" and node.args \
            and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value == "kind":
        return True
    return False


def _is_event_log(node) -> bool:
    """Receiver of an `.emit(...)` that is plausibly an EventLog: the
    `get_event_log()` accessor or a name carrying 'log'."""
    if isinstance(node, ast.Call) \
            and last_segment(call_name(node)) == "get_event_log":
        return True
    name = dotted(node)
    return name is not None and "log" in last_segment(name).lower()


def _is_registry(node) -> bool:
    """Receiver of `.counter/.gauge/.histogram/.get` that is plausibly
    a MetricsRegistry: `get_registry()` or a `reg`/`registry`-named
    binding (the repo convention)."""
    if isinstance(node, ast.Call) \
            and last_segment(call_name(node)) == "get_registry":
        return True
    name = dotted(node)
    if name is None:
        return False
    seg = last_segment(name)
    return seg in _REGISTRY_RECEIVERS or seg.endswith("_reg") \
        or seg.endswith("_registry")


def _binding_of(path: str, node) -> Optional[str]:
    """Key of the assignment target an expression ultimately lands in:
    'path:Class.attr' / 'path::name' — path-qualified so same-named
    classes/attrs in different files never collide. `node` must carry
    ._gl_parent links (set by _link_parents)."""
    cur = node
    while True:
        parent = getattr(cur, "_gl_parent", None)
        if parent is None:
            return None
        if isinstance(parent, ast.Assign):
            if len(parent.targets) == 1:
                return _target_key(path, parent.targets[0], parent)
            return None
        if isinstance(parent, (ast.Call, ast.Attribute, ast.DictComp,
                               ast.ListComp, ast.SetComp, ast.Dict,
                               ast.Tuple, ast.IfExp, ast.keyword)):
            cur = parent
            continue
        return None


def _target_key(path: str, target, node) -> Optional[str]:
    cls = _enclosing_class(node)
    prefix = f"{path}:{cls.name}." if cls is not None else f"{path}::"
    if isinstance(target, ast.Attribute) \
            and isinstance(target.value, ast.Name) \
            and target.value.id == "self":
        return prefix + target.attr
    if isinstance(target, ast.Name):
        return prefix + target.id
    return None


def _enclosing_scope(node) -> Optional[ast.AST]:
    """Nearest enclosing function def (or None at module level) via
    the _gl_parent links."""
    cur = getattr(node, "_gl_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
        cur = getattr(cur, "_gl_parent", None)
    return None


def _enclosing_class(node) -> Optional[ast.ClassDef]:
    cur = getattr(node, "_gl_parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "_gl_parent", None)
    return None


def _link_parents(ctx: FileContext) -> None:
    """Stamp child→parent links once per file (idempotent); cheaper to
    navigate than FileContext.parent's dict for the hot chains here."""
    if getattr(ctx.tree, "_gl_linked", False):
        return
    for parent in ast.walk(ctx.tree):
        for child in ast.iter_child_nodes(parent):
            child._gl_parent = parent  # type: ignore[attr-defined]
    ctx.tree._gl_linked = True  # type: ignore[attr-defined]


def _metric_registration(path: str, ctx: FileContext, node: ast.Call,
                         kind: str) -> MetricRegistration:
    _link_parents(ctx)
    name = pattern = None
    if node.args:
        a0 = node.args[0]
        if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
            name = a0.value
        elif isinstance(a0, ast.JoinedStr):
            parts = []
            for v in a0.values:
                if isinstance(v, ast.Constant):
                    parts.append(str(v.value))
                else:
                    parts.append("*")
            pattern = "".join(parts)
    labelnames: Optional[Tuple[str, ...]] = ()
    ln_node = None
    if len(node.args) >= 3:
        ln_node = node.args[2]
    for kw in node.keywords:
        if kw.arg == "labelnames":
            ln_node = kw.value
    if ln_node is not None:
        labelnames = _str_seq(ln_node)
    # chained `.labels(...)` / terminal bump on the registration chain
    chained_labels = None
    inline_bumped = False
    cur = node
    while True:
        parent = getattr(cur, "_gl_parent", None)
        if isinstance(parent, ast.Attribute):
            gp = getattr(parent, "_gl_parent", None)
            if isinstance(gp, ast.Call) and gp.func is parent:
                if parent.attr == "labels" and chained_labels is None:
                    chained_labels = gp
                elif parent.attr in _BUMP_METHODS:
                    inline_bumped = True
                cur = gp
                continue
        break
    return MetricRegistration(path, node, name, pattern, kind,
                              labelnames, _binding_of(path, node),
                              chained_labels, inline_bumped)


def _receiver_base(node):
    """Walk a bump chain `self._m_x[...].labels(...).inc()` down to its
    base Name / self-attribute; returns (base node, saw_labels_call)."""
    saw_labels = None
    cur = node
    while True:
        if isinstance(cur, ast.Call):
            if isinstance(cur.func, ast.Attribute) \
                    and cur.func.attr == "labels":
                saw_labels = cur
                cur = cur.func.value
                continue
            return None, saw_labels
        if isinstance(cur, ast.Subscript):
            cur = cur.value
            continue
        if isinstance(cur, ast.Attribute):
            if isinstance(cur.value, ast.Name) \
                    and cur.value.id == "self":
                return cur, saw_labels
            cur = cur.value
            continue
        if isinstance(cur, ast.Name):
            return cur, saw_labels
        return None, saw_labels


def _metric_bump(path: str, ctx: FileContext, node: ast.Call,
                 attr: str) -> Optional[MetricBump]:
    _link_parents(ctx)
    if attr == "labels":
        # only terminal .labels(...) starts a bump record; a .labels in
        # the middle of an .inc() chain is folded into that bump below
        parent = getattr(node, "_gl_parent", None)
        if isinstance(parent, ast.Attribute) \
                and parent.attr in _BUMP_METHODS:
            return None
        recv = node.func.value
        labels_call = node
    else:
        recv, labels_call = node.func.value, None
        if isinstance(recv, ast.Call) \
                and isinstance(recv.func, ast.Attribute) \
                and recv.func.attr == "labels":
            labels_call = recv
    base, chain_labels = _receiver_base(
        labels_call if labels_call is not None else recv)
    if labels_call is None and chain_labels is not None:
        labels_call = chain_labels
    if base is None:
        return None
    cls = _enclosing_class(node)
    if isinstance(base, ast.Attribute):
        base_name = base.attr
        binding = (f"{path}:{cls.name}.{base_name}" if cls is not None
                   else None)
    else:
        base_name = base.id
        # a plain name inside a class is a local/loop variable (often a
        # child fetched out of a family dict) — unresolvable by design
        binding = None if cls is not None else f"{path}::{base_name}"
    label_names = None
    if labels_call is not None:
        if any(kw.arg is None for kw in labels_call.keywords):
            label_names = None  # **labels splat — unknowable
        else:
            label_names = tuple(sorted(
                kw.arg for kw in labels_call.keywords))
    return MetricBump(path, node, binding, base_name, attr, label_names)


# --------------------------------------------------------------------------
# thread / lock indexing
# --------------------------------------------------------------------------

def _thread_class(path: str, node: ast.ClassDef
                  ) -> Optional[ThreadClass]:
    methods = {n.name: n for n in node.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    lock_attrs: Set[str] = set()
    sync_attrs: Set[str] = set()
    entry_methods: List[str] = []
    closure_entries: List[Tuple[str, List[ast.FunctionDef]]] = []
    for mname, m in methods.items():
        local_defs = {n.name: n for n in ast.walk(m)
                      if isinstance(n, ast.FunctionDef) and n is not m}
        for sub in ast.walk(m):
            if isinstance(sub, ast.Assign) \
                    and isinstance(sub.value, ast.Call):
                ctor = last_segment(call_name(sub.value))
                for t in sub.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        if ctor in _LOCK_TYPES:
                            lock_attrs.add(t.attr)
                        if ctor in _SYNC_TYPES:
                            sync_attrs.add(t.attr)
            if not isinstance(sub, ast.Call):
                continue
            target = _thread_target(sub)
            if target is None:
                continue
            if isinstance(target, ast.Attribute) \
                    and isinstance(target.value, ast.Name) \
                    and target.value.id == "self" \
                    and target.attr in methods:
                entry_methods.append(target.attr)
            elif isinstance(target, ast.Name) \
                    and target.id in local_defs:
                closure_entries.append((mname, _closure_group(
                    local_defs, target.id)))
    if not entry_methods and not closure_entries:
        return None
    return ThreadClass(path, node, methods, sorted(set(entry_methods)),
                       closure_entries, lock_attrs, sync_attrs)


def _thread_target(call: ast.Call):
    """The callable handed to a background execution point:
    `Thread(target=X)` or `<log>.add_listener(X)`."""
    seg = last_segment(call_name(call))
    if seg == "Thread":
        for kw in call.keywords:
            if kw.arg == "target":
                return kw.value
    if isinstance(call.func, ast.Attribute) \
            and call.func.attr == "add_listener" and call.args:
        return call.args[0]
    return None


def _closure_group(local_defs: Dict[str, ast.FunctionDef],
                   entry: str) -> List[ast.FunctionDef]:
    """`entry` plus every sibling local function it (transitively)
    calls — the watchdog's boxed()→work() pattern."""
    seen = [entry]
    frontier = [entry]
    while frontier:
        fn = local_defs[frontier.pop()]
        for sub in ast.walk(fn):
            if isinstance(sub, ast.Call) \
                    and isinstance(sub.func, ast.Name) \
                    and sub.func.id in local_defs \
                    and sub.func.id not in seen:
                seen.append(sub.func.id)
                frontier.append(sub.func.id)
    return [local_defs[n] for n in seen]
