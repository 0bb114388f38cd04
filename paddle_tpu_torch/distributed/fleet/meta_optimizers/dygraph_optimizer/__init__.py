"""Hybrid-parallel optimizer wrappers (`paddle_tpu/distributed/fleet/
meta_optimizers/dygraph_optimizer/__init__.py`; reference
`fleet/meta_optimizers/dygraph_optimizer/`).

`HybridParallelOptimizer` and `HybridParallelGradScaler` wrap the inner
optimizer and scaler. Under data parallelism the gradients are already the
mean over the ranks when `backward()` returns (`DataParallel`'s reducer),
so the step is the inner optimizer's; the clip across model-parallel and
pipeline groups comes with those groups' layers (ROADMAP A9c), as does
`DygraphShardingOptimizer` (ZeRO-1).
"""

from __future__ import annotations

__all__ = ["HybridParallelOptimizer", "HybridParallelGradScaler"]


class HybridParallelOptimizer:
    def __init__(self, optimizer, hcg, strategy=None):
        self._inner_opt = optimizer
        self._hcg = hcg
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner_opt"], name)

    def step(self):
        self._inner_opt.step()

    def clear_grad(self, set_to_zero=True):
        self._inner_opt.clear_grad(set_to_zero)

    def minimize(self, *a, **k):
        return self._inner_opt.minimize(*a, **k)

    def state_dict(self):
        return self._inner_opt.state_dict()

    def set_state_dict(self, sd):
        return self._inner_opt.set_state_dict(sd)


class HybridParallelGradScaler:
    def __init__(self, scaler, hcg):
        self._scaler = scaler
        self._hcg = hcg

    def __getattr__(self, name):
        return getattr(self.__dict__["_scaler"], name)
