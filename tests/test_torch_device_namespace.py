"""`paddle.device` of the port (`paddle_tpu_torch/device/`): the JAX
package's 30 names resolve, `set_device`/`get_device` round-trip, the
device resolution every entry point imports from it stays, and without a
card `Stream`/`Event`/`stream_guard` behave as the namespace's docstring
states. Streams, events and the memory statistics on the card are held in
`chip_smoke.py`'s device phase."""

import inspect

import pytest
import torch

import paddle_tpu.device as ref_device
import paddle_tpu_torch as paddle
from paddle_tpu_torch.framework import device as framework_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

NAMES = sorted(ref_device.__all__)
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="the CPU behaviour, without a card")


@pytest.fixture
def cpu_place():
    prev = framework_device._current
    paddle.set_device("cpu")
    yield
    framework_device._current = prev


def test_the_thirty_names():
    assert len(NAMES) == 30
    assert set(paddle.device.__all__) == set(NAMES) | {"resolve_device",
                                                       "check_device"}


@pytest.mark.parametrize("name", NAMES)
def test_each_name_resolves_as_the_jax_packages_kind(name):
    port, ref = getattr(paddle.device, name), getattr(ref_device, name)
    assert inspect.isclass(port) == inspect.isclass(ref)
    assert callable(port) == callable(ref)


def test_the_namespace_is_the_package_and_keeps_resolution():
    from paddle_tpu_torch.device import check_device, resolve_device

    assert paddle.device is __import__("paddle_tpu_torch.device",
                                       fromlist=["x"])
    assert resolve_device("cpu") == torch.device("cpu")
    check_device(torch.device("cpu"), torch.device("cpu"))
    assert paddle.device.set_device is framework_device.set_device
    assert paddle.device.cuda.Stream is paddle.device.Stream
    assert paddle.device.xpu is paddle.device.cuda
    assert callable(paddle.device.cuda.max_memory_allocated)


def test_set_device_and_get_device_round_trip(cpu_place):
    assert paddle.device.set_device("cpu") == torch.device("cpu")
    assert paddle.device.get_device() == "cpu"
    assert paddle.get_device() == "cpu"
    assert paddle.to_tensor([1.0])._data.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        paddle.device.set_device("npu")


@NO_CARD
def test_streams_and_events_raise_without_a_card():
    for make in (paddle.device.Stream, paddle.device.Event,
                 paddle.device.current_stream,
                 paddle.device.cuda.current_stream):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            make()


@NO_CARD
def test_the_rest_without_a_card(cpu_place):
    """stream_guard(None) runs its block; synchronize and empty_cache do
    nothing; the statistics read 0; the device lists hold the CPU only."""
    ran = []
    with paddle.device.stream_guard(None):
        ran.append(1)
    assert ran == [1]
    paddle.device.synchronize()
    paddle.device.empty_cache()
    for stat in ("memory_allocated", "max_memory_allocated",
                 "memory_reserved", "max_memory_reserved"):
        assert getattr(paddle.device, stat)() == 0
        assert getattr(paddle.device.cuda, stat)() == 0
    assert paddle.device.device_count() == 0
    assert paddle.device.get_all_device_type() == ["cpu"]
    assert paddle.device.get_available_device() == []
    assert paddle.device.get_available_custom_device() == []
    assert paddle.device.get_all_custom_device_type() == []
    assert paddle.device.get_cudnn_version() is None
    assert paddle.device.is_compiled_with_cinn() is False
    assert paddle.device.is_compiled_with_ipu() is False
    assert paddle.device.is_compiled_with_xpu() is False
    assert paddle.device.is_compiled_with_distribute() == \
        torch.distributed.is_available()
    with pytest.raises(RuntimeError, match="IPU"):
        paddle.device.IPUPlace()
    assert repr(paddle.device.XPUPlace(1)) == "Place(xpu->gpu:1)"
