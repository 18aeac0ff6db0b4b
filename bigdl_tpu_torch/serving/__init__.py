"""Serving plane of the port (counterpart: bigdl_tpu/serving/): the
continuous-batching engine over the paged KV cache with its
reliability layer (deadlines, cancellation, shed policies, the step
watchdog and retries, drain and health), telemetry, tenant KV quotas,
the host spill tier, disaggregated prefill and tensor-parallel serving
(tp.py); its host-side block allocator, radix prefix cache, bucketing
and sampler; the int8 serving-weight layout; and the fleet above it:
`EngineRouter` (router.py), `TenancyController` (tenancy.py), the
`Autoscaler` (autoscaler.py) and `SpeculativeEngine`
(speculative.py). The JAX package's draft distiller, vision engine,
scenario compiler and fleet simulator wait for ROADMAP.md queue A.9."""

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
from bigdl_tpu_torch.serving.kv_pool import BlockPool
from bigdl_tpu_torch.serving.prefix_cache import RadixPrefixCache
from bigdl_tpu_torch.serving.quant import (QuantWeight, params_bytes,
                                           quantize_serving_params)
from bigdl_tpu_torch.serving.router import (ROUTER_LATENCY_BUCKETS,
                                            EngineRouter, NoHealthyEngine)
from bigdl_tpu_torch.serving.sampler import filter_logits, sample_logits
from bigdl_tpu_torch.serving.speculative import SpeculativeEngine
from bigdl_tpu_torch.serving.tenancy import (TenancyController, TenantSpec,
                                             TokenBucket)
from bigdl_tpu_torch.serving.tp import (TPServingLM, gather_serving_params,
                                        shard_serving_params,
                                        tp_serving_model, tp_serving_specs)

__all__ = ["Autoscaler", "BlockPool", "EngineDegraded", "EngineDraining",
           "EngineRouter", "GenerationResult", "HandoffPackage",
           "InferenceEngine", "NoHealthyEngine", "OVERLOAD_POLICIES",
           "OverloadError", "QuantWeight", "ROUTER_LATENCY_BUCKETS",
           "RadixPrefixCache", "Request", "STATUSES",
           "SpeculativeEngine", "StepTimeout", "TPServingLM",
           "TenancyController", "TenantSpec", "TokenBucket",
           "gather_serving_params", "shard_serving_params",
           "tp_serving_model", "tp_serving_specs",
           "bucket_for", "bucket_histogram", "default_buckets",
           "filter_logits", "pad_rows", "pad_tokens", "params_bytes",
           "quantize_serving_params", "sample_logits"]
