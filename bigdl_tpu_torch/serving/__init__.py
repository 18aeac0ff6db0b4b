"""Serving plane of the port (counterpart: bigdl_tpu/serving/): the
continuous-batching engine over the paged KV cache with its
reliability layer (deadlines, cancellation, shed policies, the step
watchdog and retries, drain and health), the host spill tier and
disaggregated prefill; its host-side block allocator, radix prefix
cache, bucketing and sampler; and the int8 serving-weight layout."""

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
from bigdl_tpu_torch.serving.sampler import filter_logits, sample_logits

__all__ = ["BlockPool", "EngineDegraded", "EngineDraining",
           "GenerationResult", "HandoffPackage", "InferenceEngine",
           "OVERLOAD_POLICIES", "OverloadError", "QuantWeight",
           "RadixPrefixCache", "Request", "STATUSES", "StepTimeout",
           "bucket_for", "bucket_histogram", "default_buckets",
           "filter_logits", "pad_rows", "pad_tokens", "params_bytes",
           "quantize_serving_params", "sample_logits"]
