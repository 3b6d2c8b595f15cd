"""paddle_tpu_torch.parallel — the ported part of the distributed stack.

Counterpart of `paddle_tpu/parallel/`, so far: the strategy object
(`strategy.py`), the single-controller device mesh and hybrid topology
(`topology.py`), and sequence parallelism, ring and Ulysses attention
(`sp.py`), whose ring runs the hand-written ring-attention kernels. The
multi-process layer (collectives, launch, data/tensor/pipeline
parallelism, ZeRO, MoE) is not ported yet.
"""
from .strategy import DistributedStrategy  # noqa: F401
from .topology import (  # noqa: F401
    CommunicateTopology, HybridCommunicateGroup, Mesh, create_mesh, get_mesh,
    get_hybrid_communicate_group, set_mesh, use_mesh,
)
from .sp import (  # noqa: F401
    SequenceParallelAttention, ring_attention_local,
    ring_flash_attention_local, sequence_parallel_attention,
    ulysses_attention_local,
)
