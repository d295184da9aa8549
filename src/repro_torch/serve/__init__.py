"""Serving runtime (port of ``repro/serve``): the fixed-batch engine and
its sampling layer."""
from .buckets import bucket_for, prompt_buckets
from .engine import GenerationBundle, GenerationResult, make_engine
from .sampling import SamplingParams, modified_logits, sample_token

__all__ = ["GenerationBundle", "GenerationResult", "make_engine",
           "SamplingParams", "modified_logits", "sample_token",
           "bucket_for", "prompt_buckets"]
