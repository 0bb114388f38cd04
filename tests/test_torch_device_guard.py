"""Every kernel wrapper of the PyTorch port launches on the device of its
tensors, not on the CUDA runtime's current one.

Runs on the CPU: the tensors are CPU tensors that report `cuda:1` as their
device, the CUDA runtime is a stand-in whose current device is 0, and the
kernel library is a stand-in that records the current device at each call.
Each wrapper (B1-B3 through `flash_fwd` / `flash_bwd`, B4-B7 through
`attention.py`, B8, B9/B10) must load its library and call its C entry point
under a guard of `cuda:1`, and leave the current device at 0.
"""

from types import SimpleNamespace

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import attention as at
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import quantized_matmul as qm
from paddle_tpu_torch.kernels import rms_norm as rn

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

CARD = torch.device("cuda", 1)


class _OnCard1(torch.Tensor):
    """A CPU tensor that reports `cuda:1` as its device; `.to(device)` keeps
    it where it is."""

    @property
    def device(self):
        return CARD

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func is torch.Tensor.to:
            kwargs.pop("device", None)
            args = tuple(a for a in args
                         if not isinstance(a, (torch.device, str)))
        return super().__torch_function__(func, types, args, kwargs)


def _card(t):
    return t.contiguous().as_subclass(_OnCard1)


@pytest.fixture
def runtime(monkeypatch):
    """The stand-in CUDA runtime and kernel library; returns the list of
    (what, name, current device) the library saw."""
    state = {"current": 0}
    seen = []

    class Guard:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, state["current"] = state["current"], self.index

        def __exit__(self, *exc):
            state["current"] = self.prev

    class Lib:
        def __getattr__(self, fn):
            def call(*args):
                seen.append(("launch", fn, state["current"]))
                return 0
            return call

    def lib(name="attention"):
        seen.append(("load", name, state["current"]))
        return Lib()

    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, device=None, **k: real_empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: SimpleNamespace(
                            multi_processor_count=132))
    monkeypatch.setattr(_build, "lib", lib)
    monkeypatch.setattr(qm, "_sm_count", {})
    monkeypatch.setattr(rn, "_sm_count", {})
    monkeypatch.setattr(rn, "_scratch", {})
    for mod in (fa, at, qm, rn):
        monkeypatch.setattr(mod, "launches", dict(mod.launches))
    yield seen
    assert state["current"] == 0


def _rnd(gen, *shape, dtype=torch.bfloat16):
    return _card(torch.from_numpy(gen.standard_normal(shape)
                                  .astype("float32")).to(dtype))


def _held(seen, fns):
    """Every library load and call happened on cuda:1; the entry points
    called are `fns`."""
    assert seen and all(dev == 1 for _, _, dev in seen), seen
    assert [n for what, n, _ in seen if what == "launch"] == fns


def test_flash_wrappers_launch_on_their_tensors_device(runtime):
    import numpy as np

    gen = np.random.default_rng(0)
    q, do = _rnd(gen, 1, 8, 4, 64), _rnd(gen, 1, 8, 4, 64)
    k, v = _rnd(gen, 1, 8, 2, 64), _rnd(gen, 1, 8, 2, 64)
    out, lse = fa.flash_fwd(q, k, v, True)
    fa.flash_bwd(q, k, v, out, _card(lse), do, True)
    _held(runtime, ["pt_flash_fwd", "pt_flash_bwd_dq", "pt_flash_bwd_dkv"])


def test_attention_wrappers_launch_on_their_tensors_device(runtime):
    import numpy as np

    gen = np.random.default_rng(1)
    b, nh, nkv, hd, ps, P = 2, 4, 2, 64, 4, 2
    q = _rnd(gen, b, 1, nh, hd)
    ck, cv = _rnd(gen, b, nkv, 8, hd), _rnd(gen, b, nkv, 8, hd)
    pos = _card(torch.tensor([5, 3], dtype=torch.int32))
    pool = _rnd(gen, 1 + b * P, nkv, ps, hd)
    codes = _card(torch.ones(1 + b * P, nkv, ps, hd, dtype=torch.int8))
    scales = _card(torch.ones(1 + b * P, nkv))
    bt = _card(torch.arange(1, 1 + b * P, dtype=torch.int32).reshape(b, P))
    at.decode_attention(q, ck, cv, pos)
    at.window_attention(_rnd(gen, b, 2, nh, hd), ck, cv, pos)
    at.paged_decode_attention(q, pool, pool, bt, pos)
    at.paged_decode_attention(q, codes, codes, bt, pos, k_scale=scales,
                              v_scale=scales)
    _held(runtime, ["pt_decode_attention", "pt_window_attention",
                    "pt_paged_decode_attention",
                    "pt_paged_decode_attention_q8"])


def test_matmul_and_norm_wrappers_launch_on_their_tensors_device(runtime):
    import numpy as np

    gen = np.random.default_rng(2)
    w = _card(torch.ones(64, 32, dtype=torch.int8))
    s = _card(torch.ones(32))
    for m in (8, 64):   # the GEMV route, then the TMA route
        qm.weight_only_matmul(_rnd(gen, m, 64), w, s)
    x, g = _rnd(gen, 4, 64), _rnd(gen, 4, 64)
    wn = _rnd(gen, 64)
    _, r = rn.rms_norm_fwd(x, wn, 1e-6)
    rn.rms_norm_bwd(x, wn, _card(r), g)
    _held(runtime, ["pt_weight_only_matmul", "pt_weight_only_matmul",
                    "pt_rms_norm_fwd", "pt_rms_norm_bwd"])


def test_paged_wrapper_launches_its_route(runtime, monkeypatch):
    """B6/B7 on a CUDA tensor: bf16 launches the key-split kernel with
    `paged_splits` blocks a cluster (cut for the caller's bound on pos when
    given) and PAGED_SPLIT_TILES tiles a row's split, f32 the shared body
    (`splits` 0); each call one launch."""
    import numpy as np

    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *args: calls.append(
                            (fn, args[-2])) or 0 if args[-3] ==
                        at.PAGED_SPLIT_TILES else 1)
    gen = np.random.default_rng(3)
    # 2048 keys a table, 32 tiles: a cluster of 4; the bound 40: 1
    b, nh, nkv, hd, ps, P = 8, 8, 8, 64, 16, 128
    pos = _card(torch.arange(5, 5 + b, dtype=torch.int32))
    bt = _card(torch.arange(1, 1 + b * P, dtype=torch.int32).reshape(b, P))
    codes = _card(torch.ones(1 + b * P, nkv, ps, hd, dtype=torch.int8))
    scales = _card(torch.ones(1 + b * P, nkv))
    for dtype in (torch.bfloat16, torch.float32):
        q = _rnd(gen, b, 1, nh, hd, dtype=dtype)
        pool = _card(torch.zeros(1 + b * P, nkv, ps, hd, dtype=dtype))
        at.paged_decode_attention(q, pool, pool, bt, pos)
        at.paged_decode_attention(q, pool, pool, bt, pos, max_pos=40)
        at.paged_decode_attention(q, codes, codes, bt, pos, k_scale=scales,
                                  v_scale=scales, max_pos=40)
    table, bound = (at.paged_splits(P, ps, m) for m in (None, 40))
    assert (table, bound) == (4, 1)
    assert calls == [
        ("pt_paged_decode_attention", table),
        ("pt_paged_decode_attention", bound),
        ("pt_paged_decode_attention_q8", bound),
        ("pt_paged_decode_attention", 0),
        ("pt_paged_decode_attention", 0),
        ("pt_paged_decode_attention_q8", 0)]
    assert at.launches["paged_decode_attention"] == 4
    assert at.launches["paged_decode_attention_int8"] == 2


def test_decode_wrapper_launches_its_route(runtime, monkeypatch):
    """B4 on a CUDA tensor: bf16 launches the key-split kernel with
    `decode_splits` blocks a cluster, cut for the longest row the host knows
    of (an int pos: that pos; a tensor on the card: the cache's len), f32
    the shared body (`splits` 0); each call one launch."""
    import numpy as np

    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *args: calls.append(
                            (fn, args[-2])) or 0 if args[-3] ==
                        at.PAGED_SPLIT_TILES else 1)
    # an int pos goes to the card as a tensor: here, a tensor on `cuda:1`
    monkeypatch.setattr(at, "_int32_on", lambda x, b, device: _card(
        torch.as_tensor(x, dtype=torch.int32).expand(b)))
    gen = np.random.default_rng(4)
    # 8 x 8 (kv head, row) pairs, a 1029-key cache: 17 tiles
    b, nh, nkv, hd, length = 8, 8, 8, 64, 1029
    pos = _card(torch.arange(5, 5 + b, dtype=torch.int32))
    for dtype in (torch.bfloat16, torch.float32):
        q = _rnd(gen, b, 1, nh, hd, dtype=dtype)
        cache = _card(torch.zeros(b, nkv, length, hd, dtype=dtype))
        at.decode_attention(q, cache, cache, pos)
        at.decode_attention(q, cache, cache, 300)
    assert (at.decode_splits(length - 1), at.decode_splits(300)) == (3, 1)
    assert calls == [("pt_decode_attention", 3), ("pt_decode_attention", 1),
                     ("pt_decode_attention", 0), ("pt_decode_attention", 0)]
    assert at.launches["decode_attention"] == 4


def test_gemv_split_does_not_read_m(runtime, monkeypatch):
    """Fault C2 for B8's GEMV: at M = 1, 8, 9 and 16 a call launches the
    same K split (bf16: the cluster; f32: the blocks over K), so a row's
    K sums are added in one order whatever rows share its batch."""
    import numpy as np

    calls = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *args: calls.append(
                            (args[-6], args[-5], args[-9])) or 0)
    gen = np.random.default_rng(5)
    for k, n in ((4096, 4096), (4096, 11008), (11008, 4096), (1000, 999)):
        w = _card(torch.ones(k, n, dtype=torch.int8))
        s = _card(torch.ones(n))
        for dtype in (torch.bfloat16, torch.float32):
            calls.clear()
            for m in (1, 8, 9, 16):
                qm.weight_only_matmul(_rnd(gen, m, k, dtype=dtype), w, s)
            assert [c[2] for c in calls] == [1, 8, 9, 16]
            assert len({c[:2] for c in calls}) == 1, (k, n, dtype, calls)


def test_b10_scratch_is_per_stream(runtime, monkeypatch):
    """Fault C3: two streams of one card get two scratches (counter and
    partials) for B10, each stream the same one on every call."""
    import numpy as np

    stream = {"now": 7}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: SimpleNamespace(
                            cuda_stream=stream["now"]))
    seen = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *args: seen.append(
                            (stream["now"], args[6], args[7])) or 0)
    gen = np.random.default_rng(6)
    x, g, w = _rnd(gen, 4, 64), _rnd(gen, 4, 64), _rnd(gen, 64)
    r = _card(torch.ones(4))
    for now in (7, 9, 7, 9):
        stream["now"] = now
        rn.rms_norm_bwd(x, w, r, g)
    assert [s for s, _, _ in seen] == [7, 9, 7, 9]
    assert seen[0][1:] == seen[2][1:] and seen[1][1:] == seen[3][1:]
    assert seen[0][1] != seen[1][1] and seen[0][2] != seen[1][2]
    assert set(rn._scratch) == {(CARD, 7), (CARD, 9)}


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(b=st.integers(1, 6), nkv=st.sampled_from([1, 2, 4]),
       ps=st.sampled_from([8, 16]), P=st.sampled_from([4, 16, 64]),
       data=st.data())
def test_paged_wrapper_gives_a_row_its_own_cut(runtime, monkeypatch, b, nkv,
                                               ps, P, data):
    """Fault C2 through the B6 wrapper: whatever the batch (rows, kv heads,
    the other rows' pos, the caller's bound on pos at or above every row's),
    the cluster it launches and the split tiles it passes give row 0 the
    keys it gets in a batch of its own."""
    pos = data.draw(st.lists(st.integers(0, P * ps - 1), min_size=b,
                             max_size=b))
    bound = data.draw(st.none() | st.integers(max(pos), P * ps + 100))
    launched = []
    monkeypatch.setattr(_build, "launch",
                        lambda name, fn, dev, *args: launched.append(
                            (args[-3], args[-2])) or 0)

    def cut(batch_pos, max_pos):
        launched.clear()
        q = _card(torch.zeros(len(batch_pos), 1, nkv, 64,
                              dtype=torch.bfloat16))
        pool = _card(torch.zeros(1, nkv, ps, 64, dtype=torch.bfloat16))
        bt = _card(torch.zeros(len(batch_pos), P, dtype=torch.int32))
        at.paged_decode_attention(q, pool, pool, bt, _card(torch.tensor(
            batch_pos, dtype=torch.int32)), max_pos=max_pos)
        (split_tiles, cluster), = launched
        assert split_tiles == at.PAGED_SPLIT_TILES
        return [k for k in at.paged_split_keys(pos[0], P, ps, cluster) if k]

    assert cut(pos, bound) == cut(pos[:1], pos[0])
