"""Model-parallel RNG state tracker (`paddle_tpu/distributed/fleet/layers/
mpu/random.py`; reference `python/paddle/distributed/fleet/layers/mpu/
random.py`).

`RNGStatesTracker` keeps named generator states, so that dropout inside a
tensor-parallel region draws a different stream on each model-parallel
rank ('local_seed') while replicated regions share one ('global_seed'). A
state here is the state of the framework generator of the creation place
(`framework.random`): the tracker swaps it in and out. The port has no
model-parallel group yet (ROADMAP A9), so `model_parallel_random_seed`
derives the seeds of rank 0.
"""

from __future__ import annotations

import contextlib

from paddle_tpu_torch.framework import random as _random

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "determinate_seed"]

MODEL_PARALLEL_RNG = "model_parallel_rng"


class RNGStatesTracker:
    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def get_states_tracker(self):
        return dict(self.states_)

    def set_states_tracker(self, states):
        self.states_ = dict(states)

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        if name in self.states_:
            raise ValueError(f"state {name} already exists")
        gen = _random.generator(_random._device(None))
        cur = gen.get_state()
        gen.manual_seed(seed)
        self.states_[name] = gen.get_state()
        gen.set_state(cur)

    @contextlib.contextmanager
    def rng_state(self, name=MODEL_PARALLEL_RNG):
        if name not in self.states_:
            raise ValueError(f"state {name} does not exist")
        orig = _random.get_rng_state()
        _random.set_rng_state(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = _random.get_rng_state()
            _random.set_rng_state(orig)


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker():
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed=None):
    """Derive the global and local seeds of model-parallel rank 0
    (reference random.py): the port has no model-parallel group yet."""
    rank = 0
    if seed:
        global_seed = seed
        local_seed = seed * 1024 + rank * 100
    else:
        global_seed = 100
        local_seed = 2048 + rank * 100
    _RNG_STATE_TRACKER.reset()
    _RNG_STATE_TRACKER.add(MODEL_PARALLEL_RNG, local_seed)
    _random.seed(global_seed)


def determinate_seed(rng_name):
    return 0
