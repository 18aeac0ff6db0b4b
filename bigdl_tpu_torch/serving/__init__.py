"""Serving plane of the port (counterpart: bigdl_tpu/serving/): the
continuous-batching engine over the paged KV cache with its
reliability layer (deadlines, cancellation, shed policies, the step
watchdog and retries, drain and health), telemetry, tenant KV quotas,
the host spill tier, disaggregated prefill and tensor-parallel serving
(tp.py); its host-side block allocator, radix prefix cache, bucketing
and sampler; the int8 serving-weight layout; and the fleet above it:
`EngineRouter` (router.py), `TenancyController` (tenancy.py), the
`Autoscaler` (autoscaler.py), `SpeculativeEngine` (speculative.py)
and its `DraftDistiller` (distill.py), the `VisionEngine` beside the
LM pool (vision.py), the scenario compiler (scenarios.py) and the
fleet simulator (sim.py: `CostModel`, calibrated by default from a card
reading of the port, and `SimulatedEngine`). `__all__` is the JAX
package's; the int8 layout's names (`QuantWeight`, `params_bytes`,
`quantize_serving_params`) and `OVERLOAD_POLICIES` are importable
beside it."""

from bigdl_tpu_torch.serving.autoscaler import Autoscaler
from bigdl_tpu_torch.serving.bucketing import (bucket_for, bucket_histogram,
                                               default_buckets, pad_rows,
                                               pad_tokens)
from bigdl_tpu_torch.serving.engine import (OVERLOAD_POLICIES, STATUSES,
                                            EngineDegraded,
                                            EngineDraining,
                                            GenerationResult,
                                            HandoffPackage,
                                            InferenceEngine,
                                            OverloadError, Request,
                                            StepTimeout)
from bigdl_tpu_torch.serving.distill import DraftDistiller
from bigdl_tpu_torch.serving.kv_pool import BlockPool
from bigdl_tpu_torch.serving.prefix_cache import RadixPrefixCache
from bigdl_tpu_torch.serving.quant import (QuantWeight, params_bytes,
                                           quantize_serving_params)
from bigdl_tpu_torch.serving.router import (ROUTER_LATENCY_BUCKETS,
                                            EngineRouter, NoHealthyEngine)
from bigdl_tpu_torch.serving.sampler import filter_logits, sample_logits
from bigdl_tpu_torch.serving.scenarios import (BUILTIN_SCENARIOS,
                                               compile_scenario,
                                               list_scenarios,
                                               load_scenario)
from bigdl_tpu_torch.serving.sim import CostModel, SimulatedEngine
from bigdl_tpu_torch.serving.speculative import SpeculativeEngine
from bigdl_tpu_torch.serving.tenancy import (TenancyController, TenantSpec,
                                             TokenBucket)
from bigdl_tpu_torch.serving.tp import (TPServingLM, gather_serving_params,
                                        shard_serving_params,
                                        tp_serving_model, tp_serving_specs)
from bigdl_tpu_torch.serving.vision import VisionEngine

__all__ = [
    "InferenceEngine", "Request", "GenerationResult", "STATUSES",
    "OverloadError", "StepTimeout", "EngineDegraded", "EngineDraining",
    "HandoffPackage", "EngineRouter", "NoHealthyEngine",
    "ROUTER_LATENCY_BUCKETS",
    "SpeculativeEngine", "DraftDistiller",
    "TenancyController", "TenantSpec", "TokenBucket", "VisionEngine",
    "TPServingLM", "tp_serving_model", "tp_serving_specs",
    "gather_serving_params", "shard_serving_params",
    "CostModel", "SimulatedEngine", "BUILTIN_SCENARIOS",
    "compile_scenario", "load_scenario", "list_scenarios",
    "Autoscaler", "BlockPool", "RadixPrefixCache",
    "sample_logits", "filter_logits",
    "bucket_for", "bucket_histogram", "default_buckets", "pad_tokens",
    "pad_rows",
]
