"""hidden-device-sync — no device→host fetches on hot or emission paths.

Ports bigdl_tpu/analysis/rules/hidden_device_sync.py. Two contracts
meet here:

* obs emission consumes ALREADY-FETCHED host values: a sync hiding in
  an emission helper would stall the decode loop once per event;
* the serving decode loop performs exactly ONE deliberate fetch per
  step (the sampled tokens and their finite flags) — any other fetch
  on that path is a stealth round trip to the card.

A fetch is `.item()`, `.cpu()`, `.numpy()`, `.tolist()`,
`torch.cuda.synchronize()`, an event's or stream's `.synchronize()`,
or `np.asarray`/`np.array` of a tensor (and, for the JAX package's
fixtures, `jax.device_get` and `.block_until_ready()`). The deliberate
fetches carry an inline `# graftlint: disable=hidden-device-sync` with
their justification; everything else is a finding.

Scope: all of `bigdl_tpu_torch/obs/`, plus the hot-path functions
(decode/prefill/step/dispatch/sample/work/emit/observe, the paged-cache
lookup/insert/evict/alloc paths, handoff and placement, the journey
and flight-recorder paths, verify/rollback/mirror/spec, the spill tier,
quant/repack, swap/distill/adapt) in `serving/`, `ops/kv_cache.py`,
`ops/paged_decode.py`, `models/transformer.py` and
`parallel/param_layout.py`: block-table and radix-tree surgery, the
speculative acceptance loop and a hot swap all run between decode
steps, so a sync there stalls the whole batch.
"""

from __future__ import annotations

import ast
import re

from bigdl_tpu_torch.analysis.engine import Rule, register
from bigdl_tpu_torch.analysis.rules._common import call_name

# torch's fetches and waits, and the JAX package's names (so that the
# rule reads the JAX package's fixtures as its own engine does)
_SYNC_CALLS = {"np.asarray", "numpy.asarray", "np.array",
               "numpy.array", "torch.cuda.synchronize",
               "jax.device_get", "device_get", "jax.block_until_ready"}
_SYNC_METHODS = {"item", "cpu", "numpy", "tolist", "synchronize",
                 "block_until_ready", "__array__"}
_HOT_FN = re.compile(
    r"(decode|prefill|dispatch|step|sample|work|emit|observe"
    r"|lookup|insert|evict|alloc|handoff|place"
    r"|journey|record|dump|bundle|flight"
    r"|verify|rollback|mirror|spec"
    r"|spill|readmit|migrate"
    r"|quant|repack"
    r"|swap|distill|adapt)")


@register
class HiddenDeviceSync(Rule):
    name = "hidden-device-sync"
    severity = "error"
    description = ("device→host fetch on a decode/step hot path or "
                   "obs emission path")
    scope = ("bigdl_tpu_torch/obs/", "bigdl_tpu_torch/serving/",
             "bigdl_tpu_torch/ops/kv_cache.py",
             "bigdl_tpu_torch/ops/paged_decode.py",
             "bigdl_tpu_torch/models/transformer.py",
             "bigdl_tpu_torch/parallel/param_layout.py")

    def _in_scope(self, ctx, node) -> bool:
        fns = ctx.enclosing_functions(node)
        if not fns:
            return False
        if ctx.path.startswith("bigdl_tpu_torch/obs/"):
            return True
        return any(_HOT_FN.search(fn.name) for fn in fns)

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            hit = None
            if name in _SYNC_CALLS:
                hit = name
            elif isinstance(node.func, ast.Attribute) \
                    and not node.args and not node.keywords \
                    and node.func.attr in _SYNC_METHODS:
                # the attribute itself: `x.argmax(-1).item()` has no
                # dotted name
                hit = f".{node.func.attr}()"
            if hit is None or not self._in_scope(ctx, node):
                continue
            yield self.finding(
                ctx, node,
                f"{hit} forces a device→host sync on a hot/emission "
                f"path — consume already-fetched host values (the one "
                f"deliberate per-step fetch carries an inline "
                f"suppression with its why)")
