"""DistributedStrategy — the fleet configuration object.

Counterpart of `paddle_tpu/parallel/strategy.py`, copied: the same toggles
and defaults, so a strategy written for the JAX package configures the
port unchanged. `hybrid_configs` (its `sp_degree` included) is what
`topology.HybridCommunicateGroup` reads; the other toggles are recorded
for the parts of the distributed stack that are not ported yet.
"""
from __future__ import annotations


class DistributedStrategy:
    def __init__(self):
        # hybrid parallelism degrees (topology.py consumes these)
        self.hybrid_configs = {
            "dp_degree": 1,
            "mp_degree": 1,
            "pp_degree": 1,
            "sharding_degree": 1,
            "sp_degree": 1,  # sequence/context parallel axis
        }
        # amp
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_bf16": True,
                            "custom_white_list": [], "custom_black_list": []}
        # recompute
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        # sharding (static-style config)
        self.sharding = False
        self.sharding_configs = {"stage": 1, "sharding_degree": 1}
        # pipeline
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        # tensor parallel
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        # gradient merge
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        # misc parity toggles (recorded)
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "sparsity": 0.999}
        self.lamb = False
        self.lars = False
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 4}
        self.a_sync = False
        self.heter_ccl_mode = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.sync_nccl_allreduce = False
        self.fp16_allreduce = False
        self.last_comm_group_size_MB = 1
        self.without_graph_optimization = False
        self.asp = False

    def to_dict(self):
        return dict(self.__dict__)

    def __repr__(self):
        on = [k for k, v in self.__dict__.items() if v is True]
        return f"DistributedStrategy(hybrid={self.hybrid_configs}, enabled={on})"
