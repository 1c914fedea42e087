"""DistributedStrategy — counterpart of
``paddle_tpu.distributed.fleet.distributed_strategy``: the reference's
property bag (Paddle's ``distributed_strategy.proto`` toggles and
per-feature configs) with the same field names and defaults, so user
configs carry over unchanged. ``amp_configs['use_bf16']`` defaults to
True, as in the reference.
"""
from __future__ import annotations

import copy

__all__ = ["DistributedStrategy"]


_DEFAULTS = dict(
    # proto :146-195 toggles
    amp=False,
    recompute=False,
    localsgd=False,
    adaptive_localsgd=False,
    dgc=False,
    gradient_merge=False,
    lars=False,
    lamb=False,
    sharding=False,
    pipeline=False,
    tensor_parallel=False,
    fp16_allreduce=False,
    a_sync=False,
    elastic=False,
    auto=False,
    semi_auto=False,
    without_graph_optimization=False,
    find_unused_parameters=False,
    fuse_grad_size_in_MB=32,
    fuse_grad_size_in_TFLOPS=50.0,
    nccl_comm_num=1,
    sync_nccl_allreduce=True,
    use_hierarchical_allreduce=False,
    hierarchical_allreduce_inter_nranks=1,
    sync_batch_norm=False,
    fuse_all_reduce_ops=True,
    cudnn_exhaustive_search=False,
    conv_workspace_size_limit=512,
    cudnn_batchnorm_spatial_persistent=False,
    last_comm_group_size_MB=1.0,
    heter_ccl_mode=False,
)

_CONFIG_DEFAULTS = dict(
    # AMPConfig proto :52-64
    amp_configs=dict(
        init_loss_scaling=32768.0,
        incr_every_n_steps=1000,
        decr_every_n_nan_or_inf=2,
        incr_ratio=2.0,
        decr_ratio=0.8,
        use_dynamic_loss_scaling=True,
        custom_white_list=[],
        custom_black_list=[],
        custom_black_varnames=[],
        use_pure_fp16=False,
        use_fp16_guard=True,
        use_bf16=True,
    ),
    # RecomputeConfig proto :25-28
    recompute_configs=dict(
        checkpoints=[],
        enable_offload=False,
        checkpoint_shape=[],
    ),
    # ShardingConfig proto :31-44
    sharding_configs=dict(
        segment_broadcast_MB=32.0,
        segment_anchors=[],
        sharding_degree=8,
        mp_degree=1,
        dp_degree=1,
        pp_degree=1,
        stage=1,
        offload=False,
        hybrid_dp=False,
        gradient_merge_acc_step=1,
        optimize_offload=False,
        pp_allreduce_in_optimize=False,
    ),
    # HybridConfig proto :46-50
    hybrid_configs=dict(
        dp_degree=-1,
        mp_degree=1,
        pp_degree=1,
        sharding_degree=1,
        sp_degree=1,  # the sequence-parallel axis
    ),
    # PipelineConfig proto :136-140
    pipeline_configs=dict(
        micro_batch_size=1,
        accumulate_steps=1,
        schedule_mode="1F1B",
        p2p_cache_shape=True,
    ),
    # tensor parallel configs
    tensor_parallel_configs=dict(
        tensor_parallel_degree=1,
        tensor_init_seed=-1,
    ),
    # localsgd proto :66-74
    localsgd_configs=dict(k_steps=1, begin_step=1),
    adaptive_localsgd_configs=dict(init_k_steps=1, begin_step=1),
    # GradientMergeConfig
    gradient_merge_configs=dict(k_steps=1, avg=True),
    # DGCConfig
    dgc_configs=dict(rampup_begin_step=0, rampup_step=1, sparsity=[0.999]),
    # lars/lamb
    lars_configs=dict(lars_coeff=0.001, lars_weight_decay=0.0005, epsilon=0.0,
                      exclude_from_weight_decay=[]),
    lamb_configs=dict(lamb_weight_decay=0.01, exclude_from_weight_decay=[]),
    # AsyncConfig proto :121-134 (PS)
    a_sync_configs=dict(k_steps=-1, max_merge_var_num=1, send_queue_size=16,
                        independent_recv_thread=False,
                        min_send_grad_num_before_recv=1, thread_pool_size=1,
                        send_wait_times=1, runtime_split_send_recv=False,
                        launch_barrier=True),
    # BuildStrategy/ExecutionStrategy proto :99-119
    build_strategy=dict(fuse_elewise_add_act_ops=False, fuse_bn_act_ops=False,
                        fuse_relu_depthwise_conv=False, fuse_broadcast_ops=False,
                        fuse_all_optimizer_ops=False, enable_inplace=False,
                        enable_sequential_execution=False,
                        remove_unnecessary_lock=True, cache_runtime_context=False),
    execution_strategy=dict(num_threads=1, num_iteration_per_drop_scope=10,
                            num_iteration_per_run=1, use_thread_barrier=False),
)


class DistributedStrategy:
    def __init__(self):
        self.__dict__["_flags"] = dict(_DEFAULTS)
        self.__dict__["_configs"] = copy.deepcopy(_CONFIG_DEFAULTS)

    def __getattr__(self, name):
        if name in self._flags:
            return self._flags[name]
        if name in self._configs:
            return self._configs[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name in self._flags:
            self._flags[name] = value
        elif name in self._configs:
            assert isinstance(value, dict), f"{name} expects a dict"
            self._configs[name].update(value)
        else:
            object.__setattr__(self, name, value)

    def save_to_prototxt(self, output):
        import json

        with open(output, "w") as f:
            json.dump({"flags": self._flags, "configs": self._configs}, f, indent=2)

    def load_from_prototxt(self, pb_file):
        import json

        with open(pb_file) as f:
            data = json.load(f)
        self._flags.update(data.get("flags", {}))
        for k, v in data.get("configs", {}).items():
            self._configs.setdefault(k, {}).update(v)

    def __repr__(self):
        on = [k for k, v in self._flags.items() if v is True]
        return f"DistributedStrategy(enabled={on})"
