"""bigdl_tpu_torch.obs — telemetry (counterpart: bigdl_tpu/obs/). Ported
so far: `training.StepTelemetry`'s summary sink and log line, and from
`registry.py` the fixed-bucket latency histogram behind the serving
engine's `health()` percentiles. The named metrics registry, the event
log, spans and the live layer wait for ROADMAP.md queue A.9."""
