"""Serving plane counterpart: shape buckets, the dynamic-batching engine,
the continuous-batching LLM engine, and the fleet tier above them (the
health-routed replica pool, its autoscaler, and the online-learning
tables)."""
from .bucket import (BucketSet, ShapeBucket, default_batch_sizes,  # noqa: F401
                     signature_of)
from .engine import (DeadlineExceededError, EngineConfig,  # noqa: F401
                     EngineStoppedError, NoBucketError, ResponseFuture,
                     ServerOverloadedError, ServingEngine, ServingError)
from .fleet import (  # noqa: F401  (after engine: fleet builds on it)
    FleetError, FleetRouter, HBMBudgetExceededError, ModelTenant,
    NoHealthyReplicaError, ReplicaAgent, RolloutResult, SequenceLedger,
)
from .autoscaler import (  # noqa: F401  (after fleet: the control plane)
    Autoscaler, DecisionLedger, ReplicaPool, ScaleDecision, ScalePolicy,
)
from .online import (  # noqa: F401  (the online-learning serving plane)
    OnlineRollbackGuard, OnlineServingTable, StalenessExceededError,
    load_serving_tables, save_serving_generation,
)
from .llm import LLMConfig, LLMEngine, LLMStream  # noqa: F401

__all__ = [
    "LLMEngine", "LLMConfig", "LLMStream",
    "ServingEngine", "EngineConfig", "ResponseFuture",
    "ShapeBucket", "BucketSet", "default_batch_sizes", "signature_of",
    "ServingError", "ServerOverloadedError", "DeadlineExceededError",
    "EngineStoppedError", "NoBucketError",
    "FleetRouter", "ReplicaAgent", "ModelTenant", "SequenceLedger",
    "RolloutResult", "FleetError", "NoHealthyReplicaError",
    "HBMBudgetExceededError",
    "Autoscaler", "ScalePolicy", "ScaleDecision", "ReplicaPool",
    "DecisionLedger",
    "OnlineServingTable", "OnlineRollbackGuard", "StalenessExceededError",
    "save_serving_generation", "load_serving_tables",
]
