"""The port's lint rule set — importing this package registers every
rule with `bigdl_tpu_torch.analysis.engine.RULES`.

Ports bigdl_tpu/analysis/rules/__init__.py: its nine framework-neutral
rules. retrace-hazard, trace-env-read and donation-flow concern JAX
tracing (jit retraces, trace-time environment reads, donated buffers)
and have no counterpart in an eager PyTorch port."""

from bigdl_tpu_torch.analysis.rules import (  # noqa: F401
    event_kind_contract,
    hidden_device_sync,
    lock_discipline,
    metric_family_contract,
    missing_reference_docstring,
    nondeterministic_drill,
    telemetry_bypass,
    tf_import_in_core,
    unfenced_timing,
)
