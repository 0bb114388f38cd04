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
@pytest.mark.parametrize("b,nkv,last,sms", [
    (1, 32, 527, 132), (1, 32, 2063, 132), (8, 32, 1003, 132),
    (1, 2, 4, 132), (2, 4, 128, 132), (1, 8, 147, 132), (1, 1, 63, 132),
    (1, 1, 64, 132), (3, 5, 999, 114), (1, 32, 0, 132)])
def test_window_splits_cover_the_keys(b, nkv, last, sms):
    """Every split the rule picks for a watermark holds keys, the splits
    are in order and together cover [0, last] once; at most one cluster
    of WINDOW_MAX_SPLITS blocks, and no more blocks than fill the card
    once b * nkv alone does not."""
    splits = at.window_splits(b, nkv, last, sms)
    assert 1 <= splits <= at.WINDOW_MAX_SPLITS
    assert splits == 1 or 2 * b * nkv * splits <= sms
    keys = at.window_split_keys(last, splits)
    assert len(keys) == splits and None not in keys
    assert keys[0][0] == 0 and keys[-1][1] == last
    for (_, end), (start, _) in zip(keys, keys[1:]):
        assert start == end + 1 and start % at.WINDOW_TILE == 0


def test_window_split_keys_for_a_row_short_of_the_split_count():
    """A row whose watermark is short of the host's bound (a device pos)
    has fewer tiles than splits: some splits hold none, and the ones with
    tiles still cover [0, last] in order."""
    assert at.window_split_keys(100, 4) == [None, (0, 63), None, (64, 100)]


def test_window_last_reads_no_device_tensor():
    assert at._window_last(500, 16, 2064) == 515
    assert at._window_last(2060, 16, 2064) == 2063
    assert at._window_last(torch.tensor([3, 700]), 5, 1024) == 704
    assert at._window_last(torch.tensor([3]).to("meta"), 5, 1024) == 1023


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
