"""The port's lint engine — AST lint infrastructure for its contracts.

Ports bigdl_tpu/analysis/engine.py. Stock linters cannot see the
invariants the port lives by: telemetry consumes already-fetched host
values, the serving step makes one deliberate device fetch, timing
over device work closes with a real fetch (CUDA launches return before
the card finishes). Each is a mechanically checkable pattern; this
module is the machinery, `bigdl_tpu_torch/analysis/rules/` holds the
checks.

Pieces:

* `Rule` — one named check over a parsed file (`check(ctx)` yields
  `Finding`s); registered via the `@register` decorator, carries a
  severity and a path scope.
* `ProjectRule` — a cross-module check run once per lint over the
  shared `ProjectContext` (`analysis/project.py`) that pass 1 builds
  from the SAME parsed FileContexts — every file is parsed exactly
  once (PARSE_OBSERVERS lets a test pin that).
* `FileContext` — one file parsed once (AST + source lines + the
  per-line suppression table), shared by every rule.
* suppressions — `# graftlint: disable=rule-a,rule-b` on the offending
  line (or on a comment line directly above it) waives those rules for
  that line; `# graftlint: disable-file=rule-a` anywhere in the file
  waives the whole file. A bare `disable` (no `=`) waives every rule
  for the line. Suppressions are for *intentional* violations (e.g.
  the one deliberate per-step device fetch in the serving engine) —
  write the why next to the directive.
* baseline — `analysis/baseline.toml` grandfathers pre-existing
  findings as (rule, path, count) entries. The baseline may only
  SHRINK — stale entries that no longer match a real finding must be
  deleted, and new code never gets baselined.

The engine is pure stdlib (ast + re).
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, Iterator, List, \
    Optional, Sequence, Tuple, Union

SEVERITIES = ("error", "warning")

# files never worth linting: the schema tables generated from the
# protobuf descriptors
DEFAULT_EXCLUDES = (
    "bigdl_tpu_torch/utils/caffe/bigdl_caffe_pb2.py",
    "bigdl_tpu_torch/utils/tf/bigdl_tf_pb2.py",
    "tests/fixtures/",
)

# what `python -m bigdl_tpu_torch.analysis` lints when given a repo
# root with no explicit paths: the port and chip_smoke.py
DEFAULT_ROOTS = ("bigdl_tpu_torch", "chip_smoke.py")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint hit. `path` is repo-relative posix; `line` is 1-based."""

    rule: str
    path: str
    line: int
    col: int
    message: str
    severity: str

    def key(self) -> Tuple[str, str]:
        return (self.rule, self.path)

    def text(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.severity}: {self.message} [{self.rule}]")

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*(disable-file|disable)\s*(?:=\s*([\w,\- ]+))?")


class _Suppressions:
    """Per-file suppression table parsed from comments."""

    def __init__(self, lines: Sequence[str]):
        self.file_rules: set = set()
        self.file_all = False
        # line number -> set of rule names ('*' = all)
        self.by_line: Dict[int, set] = {}
        for i, raw in enumerate(lines, start=1):
            m = _SUPPRESS_RE.search(raw)
            if not m:
                continue
            kind, arg = m.group(1), m.group(2)
            rules = {r.strip() for r in arg.split(",")} if arg else {"*"}
            rules.discard("")
            if kind == "disable-file":
                if "*" in rules:
                    self.file_all = True
                self.file_rules |= rules
                continue
            targets = {i}
            # a comment-only directive line applies to the next line
            if raw.lstrip().startswith("#"):
                targets.add(i + 1)
            for t in targets:
                self.by_line.setdefault(t, set()).update(rules)

    def suppressed(self, rule: str, line: int) -> bool:
        if self.file_all or rule in self.file_rules:
            return True
        here = self.by_line.get(line, ())
        return "*" in here or rule in here


# observers called with the repo-relative path each time a file is
# PARSED into a FileContext — a test hooks this to pin the "every file
# parsed exactly once per run" contract of the two-pass engine
PARSE_OBSERVERS: List[Callable[[str], None]] = []


class FileContext:
    """One source file, parsed once and handed to every rule."""

    def __init__(self, path: str, source: str):
        self.path = path          # repo-relative, posix separators
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        for _obs in PARSE_OBSERVERS:
            _obs(path)
        self.suppressions = _Suppressions(self.lines)
        # lazily-built parent map for rules that need upward navigation
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        if self._parents is None:
            self._parents = {}
            for p in ast.walk(self.tree):
                for c in ast.iter_child_nodes(p):
                    self._parents[c] = p
        return self._parents.get(node)

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first chain of FunctionDef/AsyncFunctionDef
        containing `node`."""
        out = []
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self.parent(cur)
        return out


class Rule:
    """Base class. Subclasses set `name`, `severity`, `description`,
    optionally `scope` (path prefixes relative to the repo root; a
    file is checked iff it starts with one of them — empty scope means
    every linted file), and implement `check`."""

    name: str = ""
    severity: str = "error"
    description: str = ""
    scope: Tuple[str, ...] = ()

    def applies_to(self, path: str) -> bool:
        if not self.scope:
            return True
        return any(path.startswith(s) for s in self.scope)

    def check(self, ctx: FileContext) -> Iterable[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST,
                message: str) -> Finding:
        return Finding(self.name, ctx.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0) + 1, message,
                       self.severity)


class ProjectRule(Rule):
    """A cross-module rule: checked once per run over the shared
    `ProjectContext` (pass 2) instead of per file. Subclasses implement
    `check_project(pctx)`; the per-file `check` is a no-op. Project
    rules run on full-tree lints and wherever an explicit
    `project_scope` is supplied (the fixture trees); a bare path-subset
    run skips them — a subset cannot distinguish
    "never bumped" from "bumped in a file outside the subset"."""

    def check(self, ctx: "FileContext") -> Iterable[Finding]:
        return ()

    def check_project(self, pctx) -> Iterable[Finding]:
        raise NotImplementedError


RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator: instantiate and add to the global registry."""
    rule = cls()
    if not rule.name:
        raise ValueError(f"{cls.__name__} has no name")
    if rule.severity not in SEVERITIES:
        raise ValueError(f"{rule.name}: bad severity {rule.severity!r}")
    if rule.name in RULES:
        raise ValueError(f"duplicate rule {rule.name!r}")
    RULES[rule.name] = rule
    return cls


def _ensure_rules_loaded() -> None:
    # import side effect registers every rule exactly once
    from bigdl_tpu_torch.analysis import rules as _rules  # noqa: F401


# --------------------------------------------------------------------------
# baseline (grandfathered findings)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class BaselineEntry:
    rule: str
    path: str
    count: int = 1
    reason: str = ""


_KV_RE = re.compile(r"^(\w+)\s*=\s*(.+?)\s*$")


def parse_baseline(text: str) -> List[BaselineEntry]:
    """Parse the TOML subset baseline.toml uses: `[[finding]]` tables
    of string/int scalars plus comments (stdlib only; the format stays
    valid TOML so tooling can read it)."""
    entries: List[BaselineEntry] = []
    cur: Optional[dict] = None
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[finding]]":
            cur = {}
            entries.append(cur)  # type: ignore[arg-type]
            continue
        m = _KV_RE.match(line)
        if not m or cur is None:
            raise ValueError(f"baseline line {lineno}: cannot parse "
                             f"{raw!r}")
        key, val = m.group(1), m.group(2)
        if val.startswith(('"', "'")):
            # quote-aware: a '#' INSIDE the string is data, and only a
            # comment may follow the closing quote
            q = val[0]
            end = val.find(q, 1)
            if end < 0:
                raise ValueError(f"baseline line {lineno}: "
                                 f"unterminated string {raw!r}")
            rest = val[end + 1:].strip()
            if rest and not rest.startswith("#"):
                raise ValueError(f"baseline line {lineno}: trailing "
                                 f"garbage after string {raw!r}")
            cur[key] = val[1:end]
        else:
            cur[key] = int(val.split("#", 1)[0].strip())
    out = []
    for e in entries:  # type: ignore[assignment]
        if "rule" not in e or "path" not in e:
            raise ValueError(f"baseline entry missing rule/path: {e}")
        out.append(BaselineEntry(e["rule"], e["path"],
                                 int(e.get("count", 1)),
                                 str(e.get("reason", ""))))
    return out


def load_baseline(path: str) -> List[BaselineEntry]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return parse_baseline(f.read())


def format_baseline(entries: Sequence[BaselineEntry]) -> str:
    head = ("# graftlint baseline — grandfathered findings.\n"
            "# POLICY: this file may only shrink. Delete entries as "
            "the findings are\n# fixed; never add entries for new "
            "code (fix or inline-suppress instead).\n")
    chunks = [head]
    for e in entries:
        chunk = (f"\n[[finding]]\nrule = \"{e.rule}\"\n"
                 f"path = \"{e.path}\"\ncount = {e.count}\n")
        if e.reason:
            chunk += f"reason = \"{e.reason}\"\n"
        chunks.append(chunk)
    return "".join(chunks)


def apply_baseline(findings: Sequence[Finding],
                   baseline: Sequence[BaselineEntry]
                   ) -> Tuple[List[Finding], List[BaselineEntry]]:
    """Subtract grandfathered findings. Returns (surviving findings,
    stale entries) — a stale entry matched FEWER current findings than
    its count, i.e. the violation was (partly) fixed and the entry must
    be deleted or shrunk."""
    budget: Dict[Tuple[str, str], int] = {}
    for e in baseline:
        # duplicate (rule, path) entries SUM (hand-edited baselines may
        # split one path across entries with different reasons)
        budget[(e.rule, e.path)] = budget.get((e.rule, e.path), 0) \
            + e.count
    out: List[Finding] = []
    for f in findings:
        k = f.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
        else:
            out.append(f)
    seen_stale = set()
    stale = []
    for e in baseline:
        k = (e.rule, e.path)
        if budget.get(k, 0) > 0 and k not in seen_stale:
            seen_stale.add(k)
            stale.append(e)
    return out, stale


# --------------------------------------------------------------------------
# the two-pass run
# --------------------------------------------------------------------------

def iter_python_files(root: str,
                      roots: Sequence[str] = DEFAULT_ROOTS,
                      excludes: Sequence[str] = DEFAULT_EXCLUDES
                      ) -> Iterator[str]:
    """Repo-relative paths of every lintable .py under `roots`."""
    for r in roots:
        full = os.path.join(root, r)
        if os.path.isfile(full):
            if r.endswith(".py"):
                yield r
            continue
        for dirpath, dirnames, filenames in os.walk(full):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "__pycache__"]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn),
                                      root).replace(os.sep, "/")
                if any(rel.startswith(x) for x in excludes):
                    continue
                yield rel


def lint_source(rel_path: str, source: str,
                rules: Optional[Sequence[Rule]] = None
                ) -> List[Finding]:
    """Lint source text AS IF it lived at `rel_path` (rule scopes and
    suppressions apply). Backs the fixture tests, where known-bad
    snippets live under tests/fixtures/ but must be judged under a
    scoped path like bigdl_tpu_torch/serving/x.py."""
    _ensure_rules_loaded()
    if rules is None:
        rules = list(RULES.values())
    out = _check_file(FileContext(rel_path, source), rules)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_file(root: str, rel_path: str,
              rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """The per-file rules over one file under `root` (a file that does
    not parse gives its parse-error finding), sorted; no project pass
    and no baseline."""
    _ensure_rules_loaded()
    ctx = _parse_file(root, rel_path)
    if isinstance(ctx, Finding):
        return [ctx]
    if rules is None:
        rules = list(RULES.values())
    return sorted(_check_file(ctx, rules),
                  key=lambda f: (f.path, f.line, f.col, f.rule))


def _parse_file(root: str, rel_path: str
                ) -> Union[FileContext, Finding]:
    with open(os.path.join(root, rel_path)) as f:
        source = f.read()
    try:
        return FileContext(rel_path, source)
    except SyntaxError as e:
        return Finding("parse-error", rel_path, e.lineno or 1, 1,
                       f"cannot parse: {e.msg}", "error")


def _check_file(ctx: FileContext, rules: Sequence[Rule]
                ) -> List[Finding]:
    out: List[Finding] = []
    for rule in rules:
        if not rule.applies_to(ctx.path):
            continue
        for f in rule.check(ctx):
            if not ctx.suppressions.suppressed(f.rule, f.line):
                out.append(f)
    return out


def run_lint(root: str,
             paths: Optional[Sequence[str]] = None,
             rule_names: Optional[Sequence[str]] = None,
             project_scope: Optional[Sequence[str]] = None
             ) -> List[Finding]:
    """Two-pass lint under repo `root`.

    Pass 1 parses every target file exactly once into a `FileContext`
    and runs the per-file rules over `paths` (repo-relative; default:
    the whole DEFAULT_ROOTS tree). Pass 2 folds the SAME parsed
    contexts into one `ProjectContext` and runs the cross-module
    `ProjectRule`s over it.

    `project_scope` controls pass 2's view of the project:
      * None + full-tree run → the project is the full tree (the
        gate's mode); None + explicit `paths` → pass 2 is SKIPPED (a
        bare subset cannot answer cross-module questions);
      * an explicit path list → the project is exactly those files
        (the fixture mini-package trees).

    Baseline is NOT applied here — callers subtract it explicitly via
    `apply_baseline` so the stale-entry check stays visible."""
    _ensure_rules_loaded()
    if rule_names is None:
        rules = list(RULES.values())
    else:
        unknown = [n for n in rule_names if n not in RULES]
        if unknown:
            raise ValueError(f"unknown rule(s): {unknown}; known: "
                             f"{sorted(RULES)}")
        rules = [RULES[n] for n in rule_names]
    file_rules = [r for r in rules if not isinstance(r, ProjectRule)]
    project_rules = [r for r in rules if isinstance(r, ProjectRule)]

    full_tree = paths is None
    if paths is None:
        paths = list(iter_python_files(root))
    contexts: Dict[str, FileContext] = {}
    findings: List[Finding] = []
    for rel in paths:
        ctx = _parse_file(root, rel)
        if isinstance(ctx, Finding):
            findings.append(ctx)
            continue
        contexts[rel] = ctx
        findings.extend(_check_file(ctx, file_rules))

    run_project = project_rules and (
        full_tree or project_scope is not None)
    if run_project:
        # an explicit list wins; a full-tree run reuses its one walk
        project_paths = (paths if project_scope is None
                         else list(project_scope))
        for rel in project_paths:
            if rel not in contexts:
                ctx = _parse_file(root, rel)
                if not isinstance(ctx, Finding):
                    contexts[rel] = ctx
        from bigdl_tpu_torch.analysis.project import ProjectContext
        pctx = ProjectContext(
            root, {p: contexts[p] for p in project_paths
                   if p in contexts})
        for rule in project_rules:
            for f in rule.check_project(pctx):
                ctx = contexts.get(f.path)
                if ctx is not None and ctx.suppressions.suppressed(
                        f.rule, f.line):
                    continue
                findings.append(f)

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
