"""unfenced-timing — timing windows over device work must close with a
real device→host wait.

Ports bigdl_tpu/analysis/rules/unfenced_timing.py. A CUDA launch
returns before the card finishes, so a `time.perf_counter()` stop-read
taken after merely *launching* device work measures the launch, not
the execution. Every timing window that contains device work must see
a genuine wait (`torch.cuda.synchronize()`, an event's
`.synchronize()`, `float(loss)`, `.item()`, `.cpu()`, `.numpy()`,
`.tolist()`, `np.asarray`) after the last launching call and before
(or on) the stop-read.

Heuristic, deliberately conservative: the window is an assignment
`t0 = time.perf_counter()` (or time.time/monotonic) to a stop
expression `time.*() - t0` in the same function; "device work" is a
call whose name looks like a step/decode/forward dispatch; a call
whose name mentions fetch/fence/sync counts as self-fencing.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List

from bigdl_tpu_torch.analysis.engine import Rule, register
from bigdl_tpu_torch.analysis.rules._common import call_name, functions, \
    last_segment

_TIME_CALLS = {"time.time", "time.monotonic", "time.perf_counter"}
_FENCE_NAMES = {"float", "int", "np.asarray", "numpy.asarray",
                "np.array", "numpy.array", "torch.cuda.synchronize",
                "jax.device_get", "device_get", "jax.block_until_ready"}
# tensor methods that wait for the device: a fetch to the host
_FENCE_METHODS = {"item", "cpu", "numpy", "tolist"}
_FENCE_HINT = re.compile(r"(fetch|fence|sync|block_until_ready)")
_DEVICE_WORK = re.compile(
    r"(?:^|_)(step|decode|prefill|forward|apply|train|sample|"
    r"run_one|dispatch|loss|grad|update)(?:$|_)")


def _is_time_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and call_name(node) in _TIME_CALLS


@register
class UnfencedTiming(Rule):
    name = "unfenced-timing"
    severity = "warning"
    description = ("time.* window over device work with no "
                   "device→host fetch before the stop-read")
    scope = ("bigdl_tpu_torch/", "chip_smoke.py")

    def check(self, ctx):
        for fn in list(functions(ctx.tree)) + [ctx.tree]:
            yield from self._check_body(ctx, fn)

    def _check_body(self, ctx, fn):
        starts: Dict[str, int] = {}       # var -> assignment line
        fences: List[int] = []
        work: List[int] = []
        stops: List[tuple] = []           # (node, var)
        # walk in source order; nested defs get their own pass, so
        # skip their interiors here
        own_nested = {n for f in ast.walk(fn)
                      if isinstance(f, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                      and f is not fn
                      for n in ast.walk(f) if n is not f}
        for node in ast.walk(fn):
            if node in own_nested:
                continue
            if isinstance(node, ast.Assign) and _is_time_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        starts[t.id] = node.lineno
            elif isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.Sub) \
                    and _is_time_call(node.left) \
                    and isinstance(node.right, ast.Name):
                stops.append((node, node.right.id))
            elif isinstance(node, ast.Call):
                name = call_name(node)
                if name in _FENCE_NAMES \
                        or _FENCE_HINT.search(last_segment(name)) \
                        or (isinstance(node.func, ast.Attribute)
                            and node.func.attr in _FENCE_METHODS):
                    fences.append(node.lineno)
                elif _DEVICE_WORK.search(last_segment(name)):
                    work.append(node.lineno)
        for node, var in stops:
            t0 = starts.get(var)
            if t0 is None:
                continue
            in_window = [w for w in work if t0 < w < node.lineno]
            if not in_window:
                continue
            last_work = max(in_window)
            if any(last_work <= f <= node.lineno for f in fences):
                continue
            yield self.finding(
                ctx, node,
                f"timing window [{var} @ line {t0} → here] contains "
                f"device work (line {last_work}) but no device→host "
                f"fetch before the stop-read — a CUDA launch returns "
                f"before the card finishes; fence with "
                f"torch.cuda.synchronize() / float(loss) / .item()")
