"""Device API (`paddle_tpu/framework/device.py`; reference
`python/paddle/device/__init__.py` set_device).

`set_device('gpu')`, `'gpu:N'`, `'cuda'` or `'cuda:N'` makes that card the
place where tensors are created; `'cpu'` the CPU. Until `set_device` is
called, creation goes to the current CUDA device through
`paddle_tpu_torch.device.resolve_device`, and raises when there is no card:
it never drifts onto the CPU. The memory stats read `torch.cuda`'s
allocator.

`Stream` and `Event` (`paddle_tpu/framework/device.py:80-180`; reference
`python/paddle/device/__init__.py` Stream/Event) wrap a `torch.cuda.Stream`
and a `torch.cuda.Event`, with Paddle's methods. Without a card they raise
RuntimeError, as Paddle's CPU build has no stream to give; `synchronize`
and `empty_cache` do nothing there and the memory statistics read 0.
"""

import contextlib

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
    """Wait for every stream of the card (nothing without one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(_cuda_device(device))


def _need_card(what):
    if not torch.cuda.is_available():
        raise RuntimeError(f"paddle.device.{what} needs a CUDA device; the "
                           "CPU has no streams")


class Stream:
    """A CUDA stream (`paddle.device.Stream`): `device` (None: the current
    card), `priority` 1 (high) or 2 (normal), as Paddle numbers them.
    `stream_base` wraps an existing `torch.cuda.Stream`."""

    def __init__(self, device=None, priority=2, stream_base=None):
        _need_card("Stream")
        if stream_base is None:
            if priority not in (1, 2):
                raise ValueError(f"priority must be 1 (high) or 2 (normal), "
                                 f"got {priority}")
            stream_base = torch.cuda.Stream(
                _cuda_device(device), priority=-1 if priority == 1 else 0)
        self._stream = stream_base
        self.device = stream_base.device

    @property
    def cuda_stream(self):
        return self._stream.cuda_stream

    def query(self):
        return self._stream.query()

    def synchronize(self):
        self._stream.synchronize()

    def wait_event(self, event):
        self._stream.wait_event(event._event)

    def wait_stream(self, stream):
        self._stream.wait_stream(getattr(stream, "_stream", stream))

    def record_event(self, event=None):
        event = Event(self.device) if event is None else event
        event.record(self)
        return event

    def __eq__(self, other):
        return isinstance(other, Stream) and self._stream == other._stream

    def __hash__(self):
        return hash(self._stream)

    def __repr__(self):
        return f"<paddle.device.Stream {self._stream.cuda_stream:#x} on " \
            f"{self.device}>"


class Event:
    """A CUDA event (`paddle.device.Event`): `record` on a stream (default
    the current one), `query`, `synchronize`, `elapsed_time` (ms, needs
    enable_timing on both)."""

    def __init__(self, device=None, enable_timing=False, blocking=False,
                 interprocess=False):
        _need_card("Event")
        self.device = _cuda_device(device) if device is not None else \
            torch.device("cuda", torch.cuda.current_device())
        self._event = torch.cuda.Event(enable_timing=enable_timing,
                                       blocking=blocking,
                                       interprocess=interprocess)

    def record(self, stream=None):
        stream = current_stream(self.device) if stream is None else stream
        self._event.record(getattr(stream, "_stream", stream))

    def query(self):
        return self._event.query()

    def synchronize(self):
        self._event.synchronize()

    def elapsed_time(self, end_event):
        return self._event.elapsed_time(end_event._event)


def current_stream(device=None):
    """The card's current stream, as a `Stream`."""
    _need_card("current_stream")
    return Stream(stream_base=torch.cuda.current_stream(
        _cuda_device(device)))


def set_stream(stream):
    """Make `stream` the current stream of its card; returns the previous
    one (Paddle's `set_stream`)."""
    prev = current_stream(stream.device)
    torch.cuda.set_stream(stream._stream)
    return prev


@contextlib.contextmanager
def stream_guard(stream=None):
    """Run the block with `stream` current on its card, then restore the
    previous stream; None runs it as it is (Paddle's `stream_guard`)."""
    if stream is None:
        yield
        return
    prev = set_stream(stream)
    try:
        yield
    finally:
        set_stream(prev)


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
    over torch.cuda: the JAX package's class's surface."""

    Stream = Stream
    Event = Event
    current_stream = staticmethod(current_stream)
    synchronize = staticmethod(synchronize)
    memory_allocated = staticmethod(memory_allocated)
    max_memory_allocated = staticmethod(max_memory_allocated)
    memory_reserved = staticmethod(memory_reserved)
    max_memory_reserved = staticmethod(max_memory_reserved)
    empty_cache = staticmethod(empty_cache)
    device_count = staticmethod(device_count)
    stream_guard = staticmethod(stream_guard)
