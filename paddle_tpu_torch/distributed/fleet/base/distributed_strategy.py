"""DistributedStrategy (counterpart of
`paddle_tpu/distributed/fleet/base/distributed_strategy.py`): the same
fields, defaults and `to_dict`, so a strategy configures either package.
Knobs the port has no machinery for (`fuse_all_reduce_ops`,
`nccl_comm_num`, `a_sync`, ...) are recorded and read by nothing, as in
the reference.
"""


class DistributedStrategy:
    def __init__(self):
        # collective/hybrid
        self.hybrid_configs = {
            "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
            "sharding_degree": 1, "sep_degree": 1,
        }
        self.pipeline_configs = {"accumulate_steps": 1, "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.sharding_configs = {"stage": 2, "offload": False,
                                 "segment_broadcast_MB": 32}
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1,
                                        "tensor_init_seed": -1}
        # feature toggles (meta-optimizer flags in the reference)
        self.amp = False
        self.amp_configs = {"init_loss_scaling": 32768.0, "use_pure_fp16": False,
                            "use_bf16": True, "custom_white_list": [],
                            "custom_black_list": []}
        self.recompute = False
        self.recompute_configs = {"checkpoints": [], "enable_offload": False}
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        self.lamb = False
        self.lars = False
        self.dgc = False
        self.dgc_configs = {"rampup_begin_step": 0, "rampup_step": 1,
                            "sparsity": [0.999]}
        self.localsgd = False
        self.localsgd_configs = {"k_steps": 1, "begin_step": 1}
        self.sharding = False
        self.pipeline = False
        self.tensor_parallel = False
        self.heter_ccl_mode = False
        self.gradient_scale_configs = {"scale_strategy": "avg"}
        self.find_unused_parameters = False
        self.fuse_grad_size_in_MB = 32
        self.fuse_all_reduce_ops = True
        self.nccl_comm_num = 1
        self.sync_batch_norm = False
        self.a_sync = False
        self.a_sync_configs = {}
        # the parameter-server table tier (read by
        # `distributed.ps.PSContext.create_table_from_strategy`)
        self.sparse_table_configs = {"table_class": "MemorySparseTable",
                                     "shard_num": 1, "ssd_path": None,
                                     "hot_capacity": 4096,
                                     "compact_ratio": 0.5}
        self.auto = False
        self.semi_auto = False
        self.without_graph_optimization = True

    def to_dict(self):
        return {k: v for k, v in self.__dict__.items()}

    def __repr__(self):
        lines = ["DistributedStrategy("]
        for k, v in sorted(self.__dict__.items()):
            lines.append(f"  {k}={v!r},")
        return "\n".join(lines) + "\n)"
