"""bigdl_tpu_torch.obs — training telemetry (counterpart:
bigdl_tpu/obs/). Only `training.StepTelemetry`'s summary sink and log
line are ported; the metrics registry, the event log, spans and the
live layer wait for ROADMAP.md queue A.9."""
