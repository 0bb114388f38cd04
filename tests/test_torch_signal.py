"""The port's `signal` (`paddle_tpu_torch/signal.py`) against the JAX
package's on the CPU, on seeded numpy inputs in f32: `frame` and
`overlap_add` on both axes, `stft` (complex, onesided and two-sided,
centred with reflect and constant padding, normalized, a window shorter
than n_fft, no window), `istft` (its round trip and against the JAX one),
and the bound `Tensor.stft` / `Tensor.istft`. Every value within rtol
1e-5, atol 1e-6 of the JAX package's."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

import paddle_tpu as J
import paddle_tpu_torch as P
from paddle_tpu_torch.framework import device as port_device

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _port_on_cpu():
    prev = port_device._current
    P.set_device("cpu")
    yield
    port_device._current = prev


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _signal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(fn, *arrays):
    """fn(module, *tensors) through both packages: (port's, JAX's) numpy."""
    return tuple(fn(M, *[M.to_tensor(a) for a in arrays]).numpy()
                 for M in (P, J))


@pytest.mark.parametrize("axis,shape", [(-1, (3, 50)), (0, (50, 3)),
                                        (-1, (2, 3, 41))])
def test_frame_matches(axis, shape):
    got, want = _both(lambda M, x: M.signal.frame(x, 8, 3, axis=axis),
                      _signal(shape))
    _close(got, want)


@pytest.mark.parametrize("axis,shape", [(-1, (3, 8, 15)), (0, (15, 8, 3))])
def test_overlap_add_matches_and_inverts_frame(axis, shape):
    x = _signal(shape, 1)
    got, want = _both(lambda M, a: M.signal.overlap_add(a, 3, axis=axis), x)
    _close(got, want)
    # frame then overlap_add with hop = frame length gives the signal back
    s = _signal((2, 24), 2)
    for M in (P, J):
        t = M.to_tensor(s)
        back = M.signal.overlap_add(M.signal.frame(t, 6, 6), 6)
        np.testing.assert_allclose(back.numpy(), s, rtol=0, atol=0)


STFT_CASES = {
    "hann_centred_reflect": dict(n_fft=64, hop_length=16, window="hann"),
    "two_sided": dict(n_fft=32, hop_length=8, window="hann",
                      onesided=False),
    "constant_pad_normalized": dict(n_fft=40, hop_length=10,
                                    window="hann", pad_mode="constant",
                                    normalized=True),
    "short_window": dict(n_fft=64, hop_length=16, win_length=40,
                         window="hann40"),
    "no_window_not_centred": dict(n_fft=32, center=False),
}


def _kw(M, case):
    kw = dict(STFT_CASES[case])
    w = kw.pop("window", None)
    if w is not None:
        n = 40 if w == "hann40" else kw["n_fft"]
        kw["window"] = M.to_tensor(np.hanning(n + 1)[:-1].astype(np.float32))
    return kw


@pytest.mark.parametrize("case", sorted(STFT_CASES))
def test_stft_matches_complex(case):
    x = _signal((2, 400), 3)
    got, want = (M.signal.stft(M.to_tensor(x), **_kw(M, case)).numpy()
                 for M in (P, J))
    assert np.iscomplexobj(got)
    _close(got, want)


@pytest.mark.parametrize("case", ["hann_centred_reflect", "two_sided",
                                  "constant_pad_normalized", "short_window"])
def test_istft_round_trip_and_matches(case):
    x = _signal((2, 400), 4)
    outs = []
    for M in (P, J):
        kw = _kw(M, case)
        kw.pop("pad_mode", None)
        spec = M.signal.stft(M.to_tensor(x), **kw)
        y = M.signal.istft(spec, length=400, **kw)
        outs.append(y.numpy())
    _close(outs[0], outs[1])
    # centred with a Hann window at a quarter hop, the frames cover every
    # sample: the round trip gives the signal back
    np.testing.assert_allclose(outs[0], x, rtol=0, atol=1e-5)


def test_tensor_methods_are_the_signal_functions():
    x = _signal((1, 300), 5)
    t = P.to_tensor(x)
    w = P.to_tensor(np.hanning(65)[:-1].astype(np.float32))
    spec = t.stft(64, 16, window=w)
    _close(spec.numpy(), P.signal.stft(t, 64, 16, window=w).numpy())
    _close(spec.istft(64, 16, window=w, length=300).numpy(),
           J.to_tensor(x).stft(64, 16, window=J.to_tensor(
               np.hanning(65)[:-1].astype(np.float32))).istft(
               64, 16, window=J.to_tensor(
                   np.hanning(65)[:-1].astype(np.float32)),
               length=300).numpy())
    assert P.Tensor.stft is P.signal.stft
    assert P.Tensor.istft is P.signal.istft
