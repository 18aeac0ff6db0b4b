"""Serving plane of the port (counterpart: bigdl_tpu/serving/): the
continuous-batching engine over the paged KV cache, with its host-side
block allocator, radix prefix cache, bucketing and sampler."""

from bigdl_tpu_torch.serving.engine import (GenerationResult,
                                            InferenceEngine,
                                            OverloadError, Request)
from bigdl_tpu_torch.serving.kv_pool import BlockPool
from bigdl_tpu_torch.serving.prefix_cache import RadixPrefixCache

__all__ = ["BlockPool", "GenerationResult", "InferenceEngine",
           "OverloadError", "RadixPrefixCache", "Request"]
