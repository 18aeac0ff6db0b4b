"""nondeterministic-drill — drill and serving code uses the injectable
clock and seeded RNG, never the wall clock or global `random`.

Ports bigdl_tpu/analysis/rules/nondeterministic_drill.py. The fault
drills are bit-deterministic by contract: every leg asserts exact
counters and events, which only works because the engine clock is
injectable (`InferenceEngine(clock=)`) and every random stream is
explicitly seeded (np.random.RandomState(seed), a seeded
torch.Generator). A `time.time()` or bare `random.random()` on those
paths reintroduces run-to-run drift. The scope is the serving plane
(engine, router, autoscaler, tenancy, speculation, scenarios and the
simulator, whose simulated time IS the injected clock), the fault plan,
`obs/slo.py` (alert evaluation is a pure function of the sampler's
window and the injected clock) and the scripts that replay on the
virtual clock, `scripts/fault_drill.py` and `scripts/loadgen.py`.

Allowed: *references* to clock functions (e.g. the
`clock: Callable = time.monotonic` default — that IS the injection
point), `time.sleep` (models injected stragglers; not a clock read),
seeded constructors (`np.random.RandomState(...)`,
`np.random.default_rng(...)`).
"""

from __future__ import annotations

import ast

from bigdl_tpu_torch.analysis.engine import Rule, register
from bigdl_tpu_torch.analysis.rules._common import call_name

_CLOCK_CALLS = {"time.time", "time.monotonic", "time.perf_counter",
                "time.monotonic_ns", "time.perf_counter_ns",
                "datetime.now", "datetime.datetime.now",
                "datetime.utcnow"}
_RNG_OK = {"np.random.RandomState", "numpy.random.RandomState",
           "np.random.default_rng", "numpy.random.default_rng",
           "np.random.SeedSequence", "numpy.random.SeedSequence"}


@register
class NondeterministicDrill(Rule):
    name = "nondeterministic-drill"
    severity = "error"
    description = ("wall clock / unseeded RNG in drill or serving "
                   "code — use the injectable clock / seeded streams")
    scope = ("bigdl_tpu_torch/serving/",
             "bigdl_tpu_torch/utils/faults.py",
             "bigdl_tpu_torch/obs/slo.py",
             "bigdl_tpu_torch/scripts/fault_drill.py",
             "bigdl_tpu_torch/scripts/loadgen.py")

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            if name in _CLOCK_CALLS:
                yield self.finding(
                    ctx, node,
                    f"{name}() bypasses the injectable clock — "
                    f"thread the engine/drill clock "
                    f"(InferenceEngine(clock=...)) so drills stay "
                    f"bit-deterministic")
            elif (name.startswith(("random.", "np.random.",
                                   "numpy.random."))
                  and name not in _RNG_OK
                  and not name.startswith(("np.random.RandomState.",
                                           "numpy.random.RandomState."))):
                yield self.finding(
                    ctx, node,
                    f"{name}() draws from a global/unseeded stream — "
                    f"use np.random.RandomState(seed) or a seeded "
                    f"torch.Generator")
