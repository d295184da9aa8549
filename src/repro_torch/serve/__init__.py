"""Serving runtime (port of ``repro/serve``): the fixed-batch engine, the
continuous-batching engine over a paged KV cache, and their sampling
layer."""
from repro_torch.models.model import PagedCacheLayout

from .continuous import ContinuousEngine, RequestResult
from .engine import (GenerationBundle, GenerationResult, SpecStats,
                     decode_logits_scan, make_engine)
from .paged import PagePool, Request, bucket_for, poisson_trace, \
    prompt_buckets
from .sampling import (SamplingParams, modified_logits, sample_token,
                       sampling_probs, speculative_accept, stream_generator)

__all__ = ["GenerationBundle", "GenerationResult", "SpecStats",
           "decode_logits_scan", "make_engine",
           "SamplingParams", "modified_logits", "sample_token",
           "sampling_probs", "speculative_accept", "stream_generator",
           "ContinuousEngine", "RequestResult", "PagedCacheLayout",
           "PagePool", "Request", "bucket_for", "poisson_trace",
           "prompt_buckets"]
