"""Kernels B4/B5/B6 of the PyTorch port
(paddle_tpu_torch/kernels/attention.py).

  - the plain PyTorch versions agree with the reference's XLA oracles
    (`quantized_matmul._*_xla`) and with its Pallas kernels run in
    interpret mode, as tests/test_paged_kv.py runs them;
  - the wrappers route CPU tensors to the plain versions without counting
    a launch, and reject what neither path takes.

The kernels themselves are held to these plain versions on the card in
tests/test_torch_kernels_cuda.py.

Inputs are made with numpy from a seed and handed to both packages.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from paddle_tpu.kernels import quantized_matmul as qm
from paddle_tpu_torch.kernels import attention as at

# f32 on both sides, outputs of magnitude <= ~3: only the summation order
# differs (XLA's einsum and online softmax vs torch's matmul)
ATOL = 2e-5


def _cache(rng, b, nkv, length, hd):
    return (rng.normal(size=(b, nkv, length, hd)).astype(np.float32),
            rng.normal(size=(b, nkv, length, hd)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


# (b, nh, nkv, hd, max_len, pos): per-row pos incl. both cache ends, GQA
# g = 1, 2, 4, and one scalar pos
DECODE_CASES = [(3, 4, 2, 32, 128, [0, 57, 127]),
                (2, 4, 4, 64, 256, [200, 5]),
                (2, 8, 2, 32, 128, [9, 100]),
                (2, 4, 2, 32, 128, 77)]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_reference(case):
    b, nh, nkv, hd, max_len, pos = case
    rng = np.random.default_rng(0)
    q = rng.normal(size=(b, 1, nh, hd)).astype(np.float32)
    ck, cv = _cache(rng, b, nkv, max_len, hd)
    sm = 1.0 / np.sqrt(hd)
    jpos = jnp.asarray(pos, jnp.int32)
    xla = qm._decode_attention_xla(jnp.asarray(q), jnp.asarray(ck),
                                   jnp.asarray(cv), jpos, sm)
    pallas = qm._decode_attention_pallas(jnp.asarray(q), jnp.asarray(ck),
                                         jnp.asarray(cv), jpos, sm,
                                         block_k=64, interpret=True)
    tpos = (pos if isinstance(pos, int)
            else torch.tensor(pos, dtype=torch.int32))
    out = at.decode_attention_plain(*_t(q, ck, cv), tpos)
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL)


# (b, s, nh, nkv, hd, max_len, pos): row 0's window overhangs the cache
# end (its watermark clamps there), s * g up to 64
WINDOW_CASES = [(2, 8, 4, 2, 32, 128, [125, 40]),
                (1, 16, 8, 2, 32, 256, [0]),
                (2, 4, 4, 4, 64, 128, [127, 3])]


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_plain_matches_reference(case):
    b, s, nh, nkv, hd, max_len, pos = case
    rng = np.random.default_rng(1)
    q = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    ck, cv = _cache(rng, b, nkv, max_len, hd)
    sm = 1.0 / np.sqrt(hd)
    jpos = jnp.asarray(pos, jnp.int32)
    xla = qm._window_attention_xla(jnp.asarray(q), jnp.asarray(ck),
                                   jnp.asarray(cv), jpos, sm)
    pallas = qm._window_attention_pallas(jnp.asarray(q), jnp.asarray(ck),
                                         jnp.asarray(cv), jpos, sm,
                                         block_k=64, interpret=True)
    out = at.window_attention_plain(*_t(q, ck, cv),
                                    torch.tensor(pos, dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL)


def _paged_inputs(rng, b, nh, nkv, hd, ps, P, n_pages):
    pk = rng.normal(size=(n_pages, nkv, ps, hd)).astype(np.float32)
    pv = rng.normal(size=(n_pages, nkv, ps, hd)).astype(np.float32)
    q = rng.normal(size=(b, 1, nh, hd)).astype(np.float32)
    return q, pk, pv


def test_paged_plain_matches_reference():
    """Rows at different depths, a page shared by two rows, null-page
    tails (test_paged_kv.py's layout), GQA g = 2."""
    rng = np.random.default_rng(2)
    b, nh, nkv, hd, ps, P = 3, 4, 2, 32, 16, 8
    q, pk, pv = _paged_inputs(rng, b, nh, nkv, hd, ps, P, 20)
    bt = np.zeros((b, P), np.int32)
    bt[0, :4] = [3, 7, 2, 11]
    bt[1, :8] = [5, 6, 8, 9, 10, 12, 13, 14]
    bt[2, :3] = [3, 15, 16]
    pos = np.array([49, 127, 33], np.int32)
    sm = 1.0 / np.sqrt(hd)
    args = [jnp.asarray(x) for x in (q, pk, pv, bt, pos)]
    xla = qm._paged_decode_attention_xla(*args, sm)
    pallas = qm._paged_decode_attention_pallas(*args, sm, interpret=True)
    out = at.paged_decode_attention_plain(*_t(q, pk, pv, bt, pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(xla), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), atol=ATOL)


def test_paged_gather_matches_reference():
    rng = np.random.default_rng(3)
    pool = rng.normal(size=(9, 2, 4, 8)).astype(np.float32)
    bt = np.array([[1, 5, 0], [8, 2, 3]], np.int32)
    ref = qm.paged_gather(jnp.asarray(pool), jnp.asarray(bt))
    out = at.paged_gather(*_t(pool, bt))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_cpu_tensors_take_the_plain_versions_uncounted():
    rng = np.random.default_rng(4)
    q, pk, pv = _paged_inputs(rng, 2, 4, 2, 16, 8, 3, 7)
    bt = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    pos = torch.tensor([20, 3], dtype=torch.int32)
    q, pk, pv = _t(q, pk, pv)
    before = dict(at.launches)
    ck, cv = at.paged_gather(pk, bt), at.paged_gather(pv, bt)
    torch.testing.assert_close(
        at.paged_decode_attention(q, pk, pv, bt, pos),
        at.paged_decode_attention_plain(q, pk, pv, bt, pos), rtol=0, atol=0)
    torch.testing.assert_close(at.decode_attention(q, ck, cv, pos),
                               at.decode_attention_plain(q, ck, cv, pos),
                               rtol=0, atol=0)
    qw = torch.randn(2, 3, 4, 16)
    torch.testing.assert_close(at.window_attention(qw, ck, cv, pos),
                               at.window_attention_plain(qw, ck, cv, pos),
                               rtol=0, atol=0)
    assert at.launches == before


def test_wrappers_reject_what_they_cannot_take():
    q = torch.randn(2, 1, 4, 16)
    ck = torch.randn(2, 2, 32, 16)
    pos = torch.tensor([3, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="one query"):
        at.decode_attention(torch.randn(2, 2, 4, 16), ck, ck, pos)
    with pytest.raises(ValueError, match="multiple of kv"):
        at.decode_attention(torch.randn(2, 1, 3, 16), ck, ck, pos)
    with pytest.raises(ValueError, match="head_dim"):
        at.window_attention(torch.randn(2, 1, 4, 8), ck, ck, pos)
    with pytest.raises(ValueError, match="do not fit"):
        at.paged_decode_attention(q, ck, ck,
                                  torch.zeros(3, 2, dtype=torch.int32), pos)
    with pytest.raises(ValueError, match="unsupported device"):
        at.decode_attention(q.to("meta"), ck.to("meta"), ck.to("meta"), pos)


# B5's split of the keys in bf16 (`window_splits`, `window_split_keys`): the
# kernel cuts each row's keys the same way on the card
@pytest.mark.parametrize("last", [527, 2063, 1003, 4, 128, 147, 63, 64, 999,
                                  0])
def test_window_splits_cover_the_keys(last):
    """The cluster the rule picks for a watermark is one split for every
    WINDOW_SPLIT_TILES tiles, at most WINDOW_MAX_SPLITS; a row at that
    watermark uses each of its blocks, every split holds keys, the splits
    are in order and together cover [0, last] once."""
    splits = at.window_splits(last)
    tiles = last // at.WINDOW_TILE + 1
    assert splits == min(at.WINDOW_MAX_SPLITS,
                         -(-tiles // at.WINDOW_SPLIT_TILES))
    keys = at.window_split_keys(last, splits)
    assert len(keys) == splits and None not in keys
    assert keys[0][0] == 0 and keys[-1][1] == last
    for (_, end), (start, _) in zip(keys, keys[1:]):
        assert start == end + 1 and start % at.WINDOW_TILE == 0


def test_window_split_keys_for_a_row_short_of_the_split_count():
    """A row whose watermark is short of the host's bound (a device pos)
    takes its own count of the cluster's blocks, in order from the first;
    the blocks past them hold none."""
    assert at.window_split_keys(100, 4) == [(0, 100), None, None, None]
    # 18 tiles: 3 splits of 6 tiles
    assert at.window_split_keys(1100, 4) == [(0, 383), (384, 767),
                                             (768, 1100), None]


def test_window_last_reads_no_device_tensor():
    assert at._window_last(500, 16, 2064) == 515
    assert at._window_last(2060, 16, 2064) == 2063
    assert at._window_last(torch.tensor([3, 700]), 5, 1024) == 704
    assert at._window_last(torch.tensor([3]).to("meta"), 5, 1024) == 1023
    # B4's bound (s = 1): min(pos, len - 1)
    assert at._window_last(300, 1, 1029) == 300
    assert at._window_last(5000, 1, 1029) == 1028


def test_b5_bar_rejects_planted_faults():
    """chip_smoke.py's per-row B5 bar (each head_dim vector within 2^-6 of
    its own max |plain|) passes the split model of the bf16 kernel and
    fails each planted fault: a key split dropped, the splits combined
    without the max rescale, the masked keys of a split wholly past a
    row's limit counted as exp(0), the last partial tile unmasked."""
    import chip_smoke as cs

    # cut to a small width: a row whose limit ends before the third of its
    # three tiles begins, the last tile partial
    q, ck, cv, pos = cs.b5_case(torch, torch.device("cpu"), torch.bfloat16,
                                1, 48, 4, 2, 64, 200, [100])
    right = at.window_attention_plain(q, ck, cv, pos)
    exact = at.window_attention_plain(q.float(), ck.float(), cv.float(), pos)
    model = cs.window_split_plain(torch, at, q, ck, cv, pos, 3)
    assert cs.flash_row_ratio(torch, model, exact, cs.TOL["bfloat16"]) <= 1.0
    faults = cs.planted_b5_faults(torch, at, q, ck, cv, pos, 3)
    assert [f for f, _, _ in faults] == list(cs.B5_FAULTS)
    for fault, wrong, right in faults:
        ratio = cs.flash_row_ratio(torch, wrong, right, cs.TOL["bfloat16"])
        assert ratio > 1.0, fault


# B6's and B7's route and split of the keys in bf16 (`paged_route`,
# `paged_splits`, `paged_split_keys`): paged_mma_kernel cuts each row's keys
# the same way on the card
def test_paged_route_takes_bf16_to_the_cluster_kernel():
    assert at.paged_route(torch.bfloat16) == "cluster"
    assert at.paged_route(torch.float32) == "shared"


@pytest.mark.parametrize("P,ps,max_pos,want", [
    (128, 16, None, 4),   # the engine's table: 2048 keys, 32 tiles
    (128, 16, 319, 1),    # ... its scheduler's bound: 5 tiles
    (128, 16, 5000, 4),   # a bound past the table clamps
    (256, 16, None, 8),   # 4096 keys: 64 tiles
    (32, 16, None, 1),    # 512 keys: one split holds their 8 tiles
    (16, 16, None, 1),    # 256 keys: 4 tiles
    (128, 16, 1024, 3),   # 1025 keys: 17 tiles
    (192, 8, None, 3),    # 1536 keys: 24 tiles
    (1, 128, None, 1),    # one page of 128 keys: 2 tiles
    (1024, 16, None, 8),  # 16384 keys: a cluster's 8 blocks
    (128, 16, 0, 1),      # every row at pos 0
])
def test_paged_splits_follow_the_longest_row(P, ps, max_pos, want):
    """The cluster is cut for the longest row the host knows of (the
    table, or the caller's bound on pos): one split for every
    PAGED_SPLIT_TILES tiles of it, at most a cluster's 8 blocks; nothing
    of the batch (rows, kv heads, the card's SMs) enters."""
    assert at.paged_splits(P, ps, max_pos) == want


@pytest.mark.parametrize("ps", [8, 16, 64, 128])
@pytest.mark.parametrize("P", [1, 4, 32])
@pytest.mark.parametrize("pos", [0, 1, 7, 63, 64, 100, 511, 1023, 4095,
                                 5000])
def test_paged_split_keys_cover_each_row_once(ps, P, pos):
    """For every cluster the rule can pick, the splits that hold keys
    cover [0, min(pos, P * ps - 1)] once, in order and in whole tiles, and
    are the row's own count of the cluster's first blocks (pos 0, a row
    ending mid-page, a row shorter than the cluster); tables up to P * ps
    = 4096 keys."""
    if P * ps > 4096:
        pytest.skip("tables up to 4096 keys")
    last = min(pos, P * ps - 1)
    for splits in range(1, at.WINDOW_MAX_SPLITS + 1):
        keys = at.paged_split_keys(pos, P, ps, splits)
        assert len(keys) == splits
        held = [k for k in keys if k is not None]
        assert held[0][0] == 0 and held[-1][1] == last
        for first, end in held:
            assert first % at.WINDOW_TILE == 0 and first <= end
        for (_, end), (start, _) in zip(held, held[1:]):
            assert start == end + 1
        # the row's own count, from the cluster's first block
        own = min(splits, at.row_splits(last, at.PAGED_SPLIT_TILES))
        assert keys[:own] == held and len(held) == own


def _paged_small(q8, dtype=torch.bfloat16):
    """A small ragged case (cut from chip_smoke.PAGED_CASES' widths): rows
    at 0, mid-page, a page edge and a long row, pages of 8, g = 2."""
    import chip_smoke as cs

    return cs.paged_cases(torch, torch.device("cpu"), dtype, 4, 4, 2, 64, 8,
                          48, (383, 0, 4, 200), q8)


@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_paged_split_model_equals_the_plain_version(q8, splits):
    """chip_smoke's model of paged_mma_kernel's split and combine (B7's
    scales folded into scores and probabilities) is the plain version's
    function: in f32 within 1e-6."""
    import chip_smoke as cs

    args, kw = _paged_small(q8, torch.float32)
    model = cs.paged_split_plain(torch, at, *args, splits, **kw)
    plain = at.paged_decode_attention_plain(*args, **kw)
    torch.testing.assert_close(model, plain, rtol=0, atol=1e-6)


@pytest.mark.parametrize("q8", [False, True])
def test_paged_bar_rejects_planted_faults(q8):
    """chip_smoke.py's per-row B6/B7 bar (each head_dim vector within 2^-6
    of its own max |plain|) passes the split model in bf16 against the
    plain version run in f32 and fails each planted fault: a split
    dropped, a split's weight wrong, the last key of a row off by one and
    (B7) a scale taken from the wrong page."""
    import chip_smoke as cs

    args, kw = _paged_small(q8)
    exact = at.paged_decode_attention_plain(
        args[0].float(), *[a.float() if a.is_floating_point() else a
                           for a in args[1:]], **kw)
    model = cs.paged_split_plain(torch, at, *args, 8, **kw)
    assert cs.flash_row_ratio(torch, model, exact, cs.TOL["bfloat16"]) <= 1.0
    faults = cs.planted_paged_faults(torch, at, args, kw, 8)
    assert [f for f, _, _ in faults] == [
        f for f, v in cs.PAGED_FAULTS.items() if q8 or v != "scale page"]
    for fault, wrong, right in faults:
        ratio = cs.flash_row_ratio(torch, wrong, right, cs.TOL["bfloat16"])
        assert ratio > 1.0, fault


# B4's split of the keys in bf16 (`decode_splits`, `decode_split_keys`):
# decode_mma_kernel cuts each row's keys of the contiguous cache the same
# way on the card
@pytest.mark.parametrize("last,want", [
    (2047, 4),    # the timing shape: 32 tiles
    (1028, 3),    # the draft's stripe: 17 tiles
    (255, 1),     # a host-known pos early in the cache
    (511, 1),     # 8 tiles: one split holds them
    (8191, 8),    # 128 tiles: a cluster's 8 blocks
    (100000, 8),  # ... and no more
    (0, 1),       # every row at pos 0
    (3071, 6),    # 48 tiles
    (2500, 5),    # 40 tiles: at most 8 a split
])
def test_decode_splits_follow_the_longest_row(last, want):
    """B4's cluster is cut for the longest row the host knows of, keys [0,
    last]: paged_splits' rule, one split for every PAGED_SPLIT_TILES
    tiles, at most a cluster."""
    assert at.decode_splits(last) == want


def _held(cut):
    return [k for k in cut if k is not None]


# fault C2: a row's cut of its keys is a function of the row alone, whatever
# else its batch holds, as long as the host's bound covers every row
@settings(max_examples=150, deadline=None)
@given(pos=st.integers(0, 6000),
       others=st.lists(st.integers(0, 6000), max_size=15),
       table=st.sampled_from([(8, 16), (64, 16), (128, 16), (256, 16),
                              (16, 64), (512, 8)]),
       slack=st.none() | st.integers(0, 3000),
       s=st.integers(1, 16))
def test_a_rows_cut_does_not_depend_on_its_batch(pos, others, table, slack,
                                                 s):
    """B6/B7 (`paged_splits` with or without the scheduler's bound on pos),
    B4 (`decode_splits` of a host-known pos, or a pos on the card) and B5
    (`window_splits`) give a row the keys it gets alone in any batch: the
    same splits, each the same keys."""
    P, ps = table
    batch = torch.tensor(others + [pos], dtype=torch.int32)
    max_pos = None if slack is None else int(batch.max()) + slack
    alone = at.paged_split_keys(pos, P, ps, at.paged_splits(P, ps, pos))
    cut = at.paged_split_keys(pos, P, ps, at.paged_splits(P, ps, max_pos))
    assert _held(cut) == _held(alone)
    length = P * ps
    for on_card in (False, True):
        known = batch.to("meta") if on_card else batch
        cluster = at.decode_splits(at._window_last(known, 1, length))
        alone = at.decode_splits(at._window_last(pos, 1, length))
        assert _held(at.decode_split_keys(pos, length, cluster)) == \
            _held(at.decode_split_keys(pos, length, alone))
        last = min(pos + s - 1, length - 1)
        cluster = at.window_splits(at._window_last(known, s, length))
        assert _held(at.window_split_keys(last, cluster)) == \
            _held(at.window_split_keys(last, at.window_splits(last)))


@pytest.mark.parametrize("length", [64, 130, 1029, 2048])
@pytest.mark.parametrize("pos", [0, 31, 63, 64, 500, 1028, 2047, 5000])
def test_decode_split_keys_cover_each_row_once(length, pos):
    """For every split count, the splits that hold keys cover [0, min(pos,
    len - 1)] once, in order and in whole tiles (a split may be empty);
    cache lengths off the 64-key tile among them (130, 1029)."""
    last = min(pos, length - 1)
    for splits in range(1, at.WINDOW_MAX_SPLITS + 1):
        keys = at.decode_split_keys(pos, length, splits)
        assert len(keys) == splits
        held = [k for k in keys if k is not None]
        assert held[0][0] == 0 and held[-1][1] == last
        for first, end in held:
            assert first % at.WINDOW_TILE == 0 and first <= end
        for (_, end), (start, _) in zip(held, held[1:]):
            assert start == end + 1
        own = min(splits, at.row_splits(last, at.PAGED_SPLIT_TILES))
        assert keys[:own] == held and len(held) == own


def _b4_small(dtype):
    """A small ragged case off the 64-key tile (cut from chip_smoke's
    B4_CASES): len 130, g = 2, rows at 129, 0, 63 and 64, the cache past
    each row's pos also as NaN."""
    import chip_smoke as cs

    return cs.b4_case(torch, torch.device("cpu"), dtype, 4, 4, 2, 64, 130,
                      (129, 0, 63, 64))


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_decode_split_model_equals_the_plain_version(splits):
    """chip_smoke's model of decode_mma_kernel's split and combine over the
    contiguous cache is the plain version's function: in f32 within 1e-6,
    over the random cache and over the cache with NaN past each row's
    pos."""
    import chip_smoke as cs

    q, ck, cv, ckn, cvn, pos = _b4_small(torch.float32)
    plain = at.decode_attention_plain(q, ck, cv, pos)
    for k, v in ((ck, cv), (ckn, cvn)):
        model = cs.decode_split_plain(torch, at, q, k, v, pos, splits)
        torch.testing.assert_close(model, plain, rtol=0, atol=1e-6)


def test_b4_bar_rejects_planted_faults():
    """chip_smoke.py's per-row B4 bar (each head_dim vector within 2^-6 of
    its own max |plain|) passes the split model in bf16 against the plain
    version run in f32 and fails each planted fault: a split dropped, a
    split's weight wrong, the last key of a row off by one, and the V rows
    past a row's pos left in P V over NaN there."""
    import chip_smoke as cs

    q, ck, cv, ckn, cvn, pos = _b4_small(torch.bfloat16)
    exact = at.decode_attention_plain(q.float(), ck.float(), cv.float(), pos)
    model = cs.decode_split_plain(torch, at, q, ckn, cvn, pos, 8)
    assert cs.flash_row_ratio(torch, model, exact, cs.TOL["bfloat16"]) <= 1.0
    faults = cs.planted_b4_faults(torch, at, q, ck, cv, ckn, cvn, pos, 8)
    assert len(faults) == 4
    for fault, wrong, right in faults:
        ratio = cs.flash_row_ratio(torch, wrong, right, cs.TOL["bfloat16"])
        assert not ratio <= 1.0, fault
