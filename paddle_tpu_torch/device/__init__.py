"""paddle.device (`paddle_tpu/device/__init__.py`; reference
`python/paddle/device/__init__.py`), and the device resolution shared by
every entry point of the port.

Resolution: the port runs on the card. An entry point given no device
takes the current CUDA device and raises when there is none: it never
drifts onto the CPU. The CPU is used only when the caller asks for it
(`device="cpu"`), as the tests do. `resolve_device` and `check_device`
are defined here, so every module that imports them from here keeps
working.

The namespace: the JAX package's 30 names. `set_device`/`get_device`, the
`is_compiled_with_*` probes, `device_count`, and `Stream`, `Event`,
`current_stream`, `synchronize`, the `memory_*`/`max_memory_*` statistics
and `empty_cache` over `torch.cuda` come from `framework.device`;
`set_stream` and `stream_guard` switch the card's current CUDA stream, as
Paddle's do. `cuda` (and `xpu`, the same class, as in the JAX package)
keeps the JAX class's surface. Without a card: `Stream`, `Event`,
`current_stream` and `set_stream` raise RuntimeError (Paddle's CPU build
has no stream to give), `stream_guard(None)` runs its block as it is,
`synchronize` and `empty_cache` do nothing, the memory statistics read 0,
`get_all_device_type()` is ["cpu"] and `get_available_device()` is [].
"""

import torch

__all__ = ["resolve_device", "check_device"]


def resolve_device(device=None):
    """The `torch.device` an entry point runs on: `device` when given
    ("cpu", "cuda", "cuda:1", a torch.device), else the current CUDA
    device. Raises RuntimeError when CUDA is asked for, explicitly or by
    default, and is not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: the port runs on "
                         "'cuda' or 'cpu'")
    return dev


def check_device(actual, device, what="model"):
    """Raise unless `actual` (a torch.device) is the resolved `device`."""
    if actual != device:
        raise ValueError(f"{what} lives on {actual} but the call runs on "
                         f"{device}; move it or pass device={actual!s}")


# -- the paddle.device namespace (after resolve_device: framework.device
# -- imports it from here) -----------------------------------------------

from paddle_tpu_torch.framework.device import (  # noqa: E402,F401
    Event, Stream, cuda, current_stream, device_count, empty_cache,
    get_all_custom_device_type, get_device, is_compiled_with_cuda,
    is_compiled_with_custom_device, is_compiled_with_rocm,
    is_compiled_with_xpu, max_memory_allocated, max_memory_reserved,
    memory_allocated, memory_reserved, set_device, set_stream, stream_guard,
    synchronize)

xpu = cuda  # the same compat surface, as in the JAX package


class IPUPlace:
    """No IPU here (reference IPUPlace): constructing one raises, as a
    build without IPU support does."""

    def __init__(self, *a, **k):
        raise RuntimeError("paddle_tpu_torch is not compiled with IPU "
                           "support")


class XPUPlace:
    """XPU requests go to the card (the JAX package routes them to its
    accelerator): `set_device(XPUPlace(n))` places on gpu:n."""

    def __init__(self, dev_id=0):
        self.dev_id = dev_id
        self.device = f"gpu:{dev_id}"

    def __repr__(self):
        return f"Place(xpu->gpu:{self.dev_id})"


def get_all_device_type():
    """The device types there are: "cpu", and "gpu" with a card."""
    return ["cpu"] + (["gpu"] if torch.cuda.is_available() else [])


def get_available_device():
    """The cards there are, as "gpu:N" ([] without one)."""
    return [f"gpu:{i}" for i in range(device_count())]


def get_available_custom_device():
    """Custom devices: none (no custom device plugin)."""
    return []


def get_cudnn_version():
    """cuDNN's version as an int, None without a card (as Paddle's build
    without CUDA returns)."""
    if not torch.cuda.is_available():
        return None
    return torch.backends.cudnn.version()


def is_compiled_with_cinn():
    return False  # torch.compile is the compiler here, not CINN


def is_compiled_with_distribute():
    return torch.distributed.is_available()


def is_compiled_with_ipu():
    return False


__all__ += [
    "Event", "Stream", "cuda", "xpu", "current_stream", "device_count",
    "empty_cache", "get_all_custom_device_type", "get_device",
    "is_compiled_with_cuda", "is_compiled_with_custom_device",
    "is_compiled_with_rocm", "is_compiled_with_xpu",
    "max_memory_allocated", "max_memory_reserved", "memory_allocated",
    "memory_reserved", "set_device", "synchronize",
    "IPUPlace", "XPUPlace", "get_all_device_type", "get_available_device",
    "get_available_custom_device", "get_cudnn_version",
    "is_compiled_with_cinn", "is_compiled_with_distribute",
    "is_compiled_with_ipu", "set_stream", "stream_guard",
]
