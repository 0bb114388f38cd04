"""DistributedStrategy, the fleet config object
(`paddle_tpu/distributed/fleet/base/distributed_strategy.py`; reference
`python/paddle/distributed/fleet/base/distributed_strategy.py:284`,
`hybrid_configs` at `:1892`, `sharding_configs` at `:1570`).

A plain attribute bag (no protobuf round trip): field names and defaults
mirror the reference, so fleet scripts port unchanged.
"""

from __future__ import annotations

import copy

__all__ = ["DistributedStrategy"]

_HYBRID_DEFAULTS = {
    "dp_degree": -1,  # -1: infer from the device count (reference default)
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "ep_degree": 1,
    "order": ["dp", "pp", "sharding", "sep", "mp"],
    "mp_configs": {},
    "pp_configs": {},
}

_SHARDING_DEFAULTS = {
    "sharding_degree": 8,
    "stage": 1,
    "offload": False,
    "segment_broadcast_MB": 32.0,
}

_PIPELINE_DEFAULTS = {
    "micro_batch_size": 1,
    "accumulate_steps": 1,
    "schedule_mode": "1F1B",
    "p2p_cache_shape": True,
}

_AMP_DEFAULTS = {
    "init_loss_scaling": 32768.0,
    "use_dynamic_loss_scaling": True,
    "custom_white_list": [],
    "custom_black_list": [],
    "use_pure_fp16": False,
    "use_bf16": True,
}

_RECOMPUTE_DEFAULTS = {"checkpoints": [], "enable_offload": False}


class DistributedStrategy:
    def __init__(self):
        self.amp = False
        self.recompute = False
        self.sharding = False
        self.pipeline = False
        self.gradient_merge = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1
        self.without_graph_optimization = True
        self._hybrid_configs = copy.deepcopy(_HYBRID_DEFAULTS)
        self._sharding_configs = copy.deepcopy(_SHARDING_DEFAULTS)
        self._pipeline_configs = copy.deepcopy(_PIPELINE_DEFAULTS)
        self._amp_configs = copy.deepcopy(_AMP_DEFAULTS)
        self._recompute_configs = copy.deepcopy(_RECOMPUTE_DEFAULTS)

    @property
    def hybrid_configs(self):
        return self._hybrid_configs

    @hybrid_configs.setter
    def hybrid_configs(self, configs):
        # reference checks unknown keys (distributed_strategy.py:1911)
        for k in configs:
            if k not in _HYBRID_DEFAULTS:
                raise ValueError(f"unknown hybrid config key {k!r}")
        self._hybrid_configs.update(configs)

    @property
    def sharding_configs(self):
        return self._sharding_configs

    @sharding_configs.setter
    def sharding_configs(self, configs):
        self._sharding_configs.update(configs)

    @property
    def pipeline_configs(self):
        return self._pipeline_configs

    @pipeline_configs.setter
    def pipeline_configs(self, configs):
        self._pipeline_configs.update(configs)

    @property
    def amp_configs(self):
        return self._amp_configs

    @amp_configs.setter
    def amp_configs(self, configs):
        self._amp_configs.update(configs)

    @property
    def recompute_configs(self):
        return self._recompute_configs

    @recompute_configs.setter
    def recompute_configs(self, configs):
        self._recompute_configs.update(configs)

    def __repr__(self):
        h = self._hybrid_configs
        return (f"DistributedStrategy(dp={h['dp_degree']}, mp={h['mp_degree']},"
                f" pp={h['pp_degree']}, sharding={h['sharding_degree']},"
                f" sep={h['sep_degree']})")
