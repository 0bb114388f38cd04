"""Device API (`paddle_tpu/framework/device.py`; reference
`python/paddle/device/__init__.py` set_device).

`set_device('gpu')`, `'gpu:N'`, `'cuda'` or `'cuda:N'` makes that card the
place where tensors are created; `'cpu'` the CPU. Until `set_device` is
called, creation goes to the current CUDA device through
`paddle_tpu_torch.device.resolve_device`, and raises when there is no card:
it never drifts onto the CPU. The memory stats read `torch.cuda`'s
allocator.
"""

import torch

from paddle_tpu_torch.device import resolve_device

_current = None   # torch.device chosen by set_device, or None


def _canonical(device):
    """'gpu' / 'gpu:N' / 'cuda:N' / 'cpu' / torch.device / a place object
    (`CPUPlace`, `CUDAPlace(n)`) -> the string `resolve_device` takes."""
    device = getattr(device, "device", device)
    if isinstance(device, torch.device):
        return str(device)
    name = str(device).lower()
    plat, _, idx = name.partition(":")
    if plat in ("gpu", "cuda"):
        return f"cuda:{idx}" if idx else "cuda"
    if plat == "cpu":
        return "cpu"
    raise ValueError(f"unsupported device {device!r}: the port runs on "
                     "'gpu' (CUDA) or 'cpu'")


def set_device(device):
    """Make `device` the place of every tensor created without one.
    Returns the torch.device."""
    global _current
    _current = resolve_device(_canonical(device))
    return _current


def place(device=None):
    """The torch.device a tensor is created on: `device` when given, else
    the one `set_device` chose, else the current CUDA device (raises when
    there is none)."""
    if device is not None:
        device = getattr(device, "device", device)
        if isinstance(device, torch.device) and device.type == "cpu":
            return device
        return resolve_device(_canonical(device))
    if _current is not None:
        return _current
    return resolve_device(None)


def get_device():
    dev = place()
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def is_compiled_with_cuda():
    return torch.backends.cuda.is_built()


def is_compiled_with_xpu():
    return False


def is_compiled_with_rocm():
    return torch.version.hip is not None


def is_compiled_with_custom_device(device_type=None):
    return False


def get_all_custom_device_type():
    return []


def device_count():
    return torch.cuda.device_count()


def synchronize(device=None):
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


def current_stream(device=None):
    return torch.cuda.current_stream(device)


def _cuda_device(device):
    if device is None or isinstance(device, int):
        return device
    return resolve_device(_canonical(device))


def memory_allocated(device=None):
    """Bytes held by live tensors on the card (0 without one)."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated(_cuda_device(device)))


def max_memory_allocated(device=None):
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.max_memory_allocated(_cuda_device(device)))


def memory_reserved(device=None):
    """Bytes the caching allocator holds, live or not."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_reserved(_cuda_device(device)))


def max_memory_reserved(device=None):
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.max_memory_reserved(_cuda_device(device)))


def empty_cache():
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class cuda:
    """paddle.device.cuda (reference `python/paddle/device/cuda/__init__.py`)
    over torch.cuda."""

    Stream = torch.cuda.Stream
    Event = torch.cuda.Event
    current_stream = staticmethod(current_stream)
    synchronize = staticmethod(synchronize)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    max_memory_reserved = staticmethod(max_memory_reserved)
    empty_cache = staticmethod(empty_cache)
    device_count = staticmethod(device_count)
    stream_guard = staticmethod(torch.cuda.stream)
