"""Global RNG (`paddle_tpu/framework/random.py`; reference
`paddle/phi/core/generator.h` and `paddle.seed`).

One explicit `torch.Generator` per device, made on first use and seeded by
`seed`. Every random op of the port draws from it (`generator=`), never
from torch's global generator. Torch's generators are not JAX's threefry:
the same seed gives other numbers than the JAX package, so the two are held
to seed reproducibility and to statistics, not to bits.
"""

import threading

import torch

_lock = threading.Lock()
_generators = {}   # (device type, index) -> torch.Generator
_seed_value = 0


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev.type, dev.index or 0


def generator(device):
    """The framework generator of `device` (a torch.device or string)."""
    key = _key(device)
    with _lock:
        gen = _generators.get(key)
        if gen is None:
            gen = torch.Generator(device=torch.device(*key) if key[0] != "cpu"
                                  else "cpu")
            gen.manual_seed(_seed_value)
            _generators[key] = gen
        return gen


def seed(s):
    """Reseed every device's generator (and those made later)."""
    global _seed_value
    with _lock:
        _seed_value = int(s)
        for gen in _generators.values():
            gen.manual_seed(_seed_value)
    return _seed_value


def _device(device):
    from paddle_tpu_torch.framework import device as device_mod

    return device_mod.place(device)


def get_rng_state(device=None):
    """The state of the generator of `device` (default: the creation
    place), a uint8 tensor `set_rng_state` takes back."""
    return generator(_device(device)).get_state()


def set_rng_state(state, device=None):
    generator(_device(device)).set_state(state)


def get_cuda_rng_state():
    return [generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(state):
    states = state if isinstance(state, (list, tuple)) else [state]
    for i, st in enumerate(states):
        generator(torch.device("cuda", i)).set_state(st)
