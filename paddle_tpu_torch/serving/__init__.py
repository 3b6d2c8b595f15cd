"""Serving plane counterpart: shape buckets, the dynamic-batching engine
and the continuous-batching LLM engine."""
from .bucket import (BucketSet, ShapeBucket, default_batch_sizes,  # noqa: F401
                     signature_of)
from .engine import (DeadlineExceededError, EngineConfig,  # noqa: F401
                     EngineStoppedError, NoBucketError, ResponseFuture,
                     ServerOverloadedError, ServingEngine, ServingError)
from .llm import LLMConfig, LLMEngine, LLMStream  # noqa: F401
