"""Kernels B1-B10 of the PyTorch port on an NVIDIA card: each kernel
agrees with its plain PyTorch version on the same inputs, counts its
launches, and rejects what it does not take. Marked `cuda`; the tests skip
where there is no card. This file imports neither JAX nor the reference
package, so the card's machine runs it without them, from the repo's root
(B1-B3 and B9/B10 are held to `chip_smoke.py`'s bars, which it imports
from there):

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

import chip_smoke as cs
from paddle_tpu_torch.kernels import attention as at
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import quantized_matmul as qm
from paddle_tpu_torch.kernels import rms_norm as rn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.device("cuda")


def _bf16_bar(ref):
    # two bf16 units in the last place at the largest output: the plain
    # version rounds its scores and probabilities to bf16, the kernel not
    # (fp16 is held to the same bar: its unit is 8 times smaller)
    return 2.0 ** -6 * max(1.0, ref.abs().max().item())


# B4-B7's dtypes: bf16 and fp16 take the cluster kernels, f32 the shared
# body
ATTN_DTYPES = [torch.bfloat16, torch.float16, torch.float32]


# B4-B7 cases on the card: (nkv, g, hd, ps, P, rows). First the cases these
# tests have always run (8 query heads, tables of 256 keys, rows at 255,
# 100, 0 and 17), then pages of 8 to 128 keys over tables of 512 keys with
# rows at 0, 1, mid-page and the full table
_OLD_ROWS = (255, 100, 0, 17)
PAGED_CARD_CASES = [(8, 1, 128, 16, 16, _OLD_ROWS),
                    (2, 4, 128, 16, 16, _OLD_ROWS),
                    (4, 2, 64, 16, 16, _OLD_ROWS)]
PAGED_Q8_CARD_CASES = [(8, 1, 128, 16, 16, _OLD_ROWS),
                       (2, 4, 128, 64, 4, _OLD_ROWS),
                       (4, 2, 64, 8, 32, _OLD_ROWS),
                       (8, 1, 128, 32, 8, _OLD_ROWS)]
_NEW_CASES = [(nkv, g, hd, ps, 512 // ps, (0, 1, 3 * ps + ps // 2, 511))
              for ps in (8, 16, 64, 128) for hd in (64, 128)
              for nkv, g in ((32, 1), (8, 4), (8, 8))]
PAGED_CARD_CASES += _NEW_CASES
PAGED_Q8_CARD_CASES += _NEW_CASES


def _paged_ok(out, again, ref, ref32, dtype):
    """bf16 and fp16 (paged_mma_kernel): each head_dim vector within 2^-6
    of its own max |plain| against the plain version run in f32, the whole
    output within the bf16 bar of the plain version, a second call
    bit-identical;
    f32 (the shared body): within 1e-5, both summing in f32 in different
    orders."""
    assert torch.isfinite(out).all()
    if dtype == torch.float32:
        return (out - ref).abs().max().item() <= 1e-5
    return (cs.flash_row_ratio(torch, out, ref32, 2.0 ** -6) <= 1.0
            and (out.float() - ref.float()).abs().max().item()
            <= _bf16_bar(ref) and torch.equal(out, again))


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("nkv,g,hd,ps,P,rows", PAGED_CARD_CASES)
def test_kernels_match_plain_on_card(cuda, dtype, nkv, g, hd, ps, P, rows):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, nh = 4, nkv * g
    n_pages = 1 + b * P

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(dtype)

    pk, pv = rnd(n_pages, nkv, ps, hd), rnd(n_pages, nkv, ps, hd)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1) \
        .reshape(b, P).to(torch.int32)
    pos = torch.tensor(rows, dtype=torch.int32, device=cuda)
    q = rnd(b, 1, nh, hd)
    ck, cv = at.paged_gather(pk, bt), at.paged_gather(pv, bt)
    # the widest window the kernel takes; the longest row's overhangs the
    # cache end
    qw = rnd(b, 64 // g, nh, hd)
    before = dict(at.launches)
    out = at.paged_decode_attention(q, pk, pv, bt, pos)
    again = at.paged_decode_attention(q, pk, pv, bt, pos)
    pairs = [(at.decode_attention(q, ck, cv, pos),
              at.decode_attention_plain(q, ck, cv, pos)),
             (at.window_attention(qw, ck, cv, pos + 200),
              at.window_attention_plain(qw, ck, cv, pos + 200))]
    ref = at.paged_decode_attention_plain(q, pk, pv, bt, pos)
    ref32 = at.paged_decode_attention_plain(q.float(), pk.float(),
                                            pv.float(), bt, pos)
    torch.cuda.synchronize()
    assert _paged_ok(out, again, ref, ref32, dtype)
    for got, want in pairs:
        # f32: both sum in f32, in different orders
        bar = _bf16_bar(want) if dtype != torch.float32 else 1e-5
        assert (got.float() - want.float()).abs().max().item() <= bar
    assert {k: at.launches[k] - before[k] for k in before} == {
        "decode_attention": 1, "window_attention": 1,
        "paged_decode_attention": 2, "paged_decode_attention_int8": 0}


def test_kernel_checks_on_card(cuda):
    q = torch.randn(2, 1, 4, 128, device=cuda)
    ck = torch.randn(2, 2, 64, 128, device=cuda)
    pos = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        at.decode_attention(q.double(), ck.double(), ck.double(), pos)
    with pytest.raises(TypeError, match="dtype mismatch"):
        at.decode_attention(q.half(), ck.bfloat16(), ck.bfloat16(), pos)
    with pytest.raises(ValueError, match="contiguous"):
        at.decode_attention(q, ck.transpose(2, 3).contiguous().transpose(2, 3),
                            ck, pos)
    with pytest.raises(ValueError, match="head_dim"):
        at.decode_attention(q[..., :96].contiguous(),
                            ck[..., :96].contiguous(),
                            ck[..., :96].contiguous(), pos)
    with pytest.raises(ValueError, match="query rows"):
        at.window_attention(torch.randn(2, 65, 2, 128, device=cuda),
                            ck, ck, pos)


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("case", range(len(cs.B4_CASES)))
def test_decode_kernel_edges_on_card(cuda, dtype, case):
    """B4 at chip_smoke's B4_CASES (a 1029-key cache, g = 1, 2, 4, 8, 64,
    both head dims, rows at 0, mid-tile and len - 1, a pos past the cache's
    end): bf16 and fp16 (decode_mma_kernel, keys by TMA) each head_dim
    vector within
    2^-6 of its own max |plain| against the plain version run in f32, the
    whole output within the bf16 bar, a second call bit-identical; f32
    (the shared body) within 1e-5. Over the cache with NaN past each row's
    pos, the same bits; one launch a call."""
    _, b, nh, nkv, hd, length, pos = cs.B4_CASES[case]
    q, ck, cv, ckn, cvn, pos_t = cs.b4_case(torch, cuda, dtype, b, nh, nkv,
                                            hd, length, pos)
    before = at.launches["decode_attention"]
    out = at.decode_attention(q, ck, cv, pos_t)
    again = at.decode_attention(q, ck, cv, pos_t)
    over_nan = at.decode_attention(q, ckn, cvn, pos_t)
    ref = at.decode_attention_plain(q, ck, cv, pos_t)
    ref32 = at.decode_attention_plain(q.float(), ck.float(), cv.float(),
                                      pos_t)
    torch.cuda.synchronize()
    assert at.launches["decode_attention"] == before + 3
    assert _paged_ok(out, again, ref, ref32, dtype)
    assert torch.equal(out, over_nan)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_decode_bar_rejects_planted_faults_on_card(cuda, dtype):
    """chip_smoke's B4 bar on the card, in bf16 and fp16: the split model
    passes, a split dropped, a split's weight wrong, a key past a row's end
    and the V rows past pos left in P V over NaN each fail."""
    cs.phase_b4_bar_teeth(torch, cuda, dtype)


def _q8_pool(g, cuda, n_pages, nkv, ps, hd):
    codes = torch.randint(-127, 128, (n_pages, nkv, ps, hd), generator=g,
                          device=cuda, dtype=torch.int8)
    return codes, torch.rand(n_pages, nkv, generator=g, device=cuda) + 0.5


@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("nkv,g,hd,ps,P,rows", PAGED_Q8_CARD_CASES)
def test_paged_q8_kernel_matches_plain_on_card(cuda, dtype, nkv, g, hd, ps,
                                               P, rows):
    """B7: ragged rows (0, 1, mid-page, the full table among them), pages
    of 8-128 (a 64-key tile spans up to 8 pages, each with its own scale),
    GQA, a page with scale 0 (row 1's first page)."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    b, nh = 4, nkv * g
    n_pages = 1 + b * P
    pk, sk = _q8_pool(gen, cuda, n_pages, nkv, ps, hd)
    pv, sv = _q8_pool(gen, cuda, n_pages, nkv, ps, hd)
    bt = (torch.randperm(n_pages - 1, generator=gen, device=cuda) + 1) \
        .reshape(b, P).to(torch.int32)
    sk[bt[1, 0]] = 0.0
    sv[bt[1, 0]] = 0.0
    pos = torch.tensor(rows, dtype=torch.int32, device=cuda)
    q = torch.randn(b, 1, nh, hd, generator=gen, device=cuda).to(dtype)
    before = at.launches["paged_decode_attention_int8"]
    out = at.paged_decode_attention(q, pk, pv, bt, pos, k_scale=sk,
                                    v_scale=sv)
    assert at.launches["paged_decode_attention_int8"] == before + 1
    again = at.paged_decode_attention(q, pk, pv, bt, pos, k_scale=sk,
                                      v_scale=sv)
    ref = at.paged_decode_attention_plain(q, pk, pv, bt, pos, k_scale=sk,
                                          v_scale=sv)
    ref32 = at.paged_decode_attention_plain(q.float(), pk, pv, bt, pos,
                                            k_scale=sk, v_scale=sv)
    torch.cuda.synchronize()
    assert at.launches["paged_decode_attention_int8"] == before + 2
    assert _paged_ok(out, again, ref, ref32, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_paged_q8_widens_every_code_exactly_on_card(cuda, dtype):
    """B7's widening of int8 codes into the query's 16-bit type (fp16: its
    own exact form, not bf16's), at every code from -127 to 127. V: one
    key a row (p = 1), v_scale 127 (a code's value is the code), so each
    output element is one code, exactly. K: every code in the pool's
    keys, the output within the bar of the plain version run in f32."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    codes = torch.arange(-127, 128, device=cuda, dtype=torch.int8)
    b, nkv, hd, ps = 2, 2, 128, 16                 # 512 V values a key slot
    vals = torch.cat([codes, codes.flip(0), codes[:2]])    # 512 entries
    pv = torch.zeros(1 + b, nkv, ps, hd, dtype=torch.int8, device=cuda)
    pv[1:, :, 0] = vals.reshape(b, nkv, hd)
    pk = torch.randint(-127, 128, pv.shape, generator=gen, device=cuda,
                       dtype=torch.int8)
    ones = torch.full((1 + b, nkv), 127.0, device=cuda)
    bt = torch.arange(1, 1 + b, dtype=torch.int32, device=cuda)[:, None]
    q = torch.randn(b, 1, nkv, hd, generator=gen, device=cuda).to(dtype)
    pos = torch.zeros(b, dtype=torch.int32, device=cuda)
    out = at.paged_decode_attention(q, pk, pv, bt, pos, k_scale=ones,
                                    v_scale=ones)
    torch.cuda.synchronize()
    assert torch.equal(out[:, 0].float(),
                       vals.reshape(b, nkv, hd).float())
    # K: every code in row 0's first two keys (each kv head), the rest
    # random; rows of 64 and 41 keys
    pk = torch.randint(-127, 128, (1 + 4 * b, nkv, ps, hd), generator=gen,
                       device=cuda, dtype=torch.int8)
    pk[1, :, :2] = vals.reshape(2, 2, hd).transpose(0, 1)
    pv = torch.randint(-127, 128, pk.shape, generator=gen, device=cuda,
                       dtype=torch.int8)
    sk = torch.rand(1 + 4 * b, nkv, generator=gen, device=cuda) + 0.5
    sv = torch.rand(1 + 4 * b, nkv, generator=gen, device=cuda) + 0.5
    bt = torch.arange(1, 1 + 4 * b, dtype=torch.int32,
                      device=cuda).reshape(b, 4)
    pos = torch.tensor([63, 40], dtype=torch.int32, device=cuda)
    out = at.paged_decode_attention(q, pk, pv, bt, pos, k_scale=sk,
                                    v_scale=sv)
    ref32 = at.paged_decode_attention_plain(q.float(), pk, pv, bt, pos,
                                            k_scale=sk, v_scale=sv)
    torch.cuda.synchronize()
    assert cs.flash_row_ratio(torch, out, ref32, 2.0 ** -6) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [(1, 4096, 4096), (8, 1000, 999),
                                   (13, 130, 520), (16, 4096, 11008),
                                   (77, 520, 300), (512, 4096, 4096)])
def test_weight_only_matmul_matches_plain_on_card(cuda, dtype, m, k, n):
    """B8 in both regimes (M <= 16 GEMV, split over K or not; M > 16
    tiles), ragged on every edge."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w, s = qm.quantize_absmax(
        torch.randn(k, n, generator=g, device=cuda) * 0.02)
    before = qm.launches["weight_only_matmul"]
    out = qm.weight_only_matmul(x, w, s)
    ref = qm.dequant_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert qm.launches["weight_only_matmul"] == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    # bf16: the plain version rounds each dequantized weight and its
    # output to bf16, the kernel sums exact codes in f32 and rounds once.
    # f32: the same products summed in another order
    bar = (_bf16_bar(ref) if dtype == torch.bfloat16
           else 1e-5 * max(1.0, ref.abs().max().item()))
    assert (out.float() - ref.float()).abs().max().item() <= bar


# B5 at the edges of the bf16 kernel's key split and row tiles
# (chip_smoke.B5_CASES), in bf16 and f32
@pytest.mark.parametrize("dtype", ATTN_DTYPES)
@pytest.mark.parametrize("case", range(len(cs.B5_CASES)))
def test_window_kernel_edges_on_card(cuda, dtype, case):
    """Each head_dim vector within its bar of the plain version run in f32
    on the same inputs, the whole output within the bar of the plain
    version itself, and a second call bit-identical."""
    _, *shape = cs.B5_CASES[case]
    q, ck, cv, pos = cs.b5_case(torch, cuda, dtype, *shape)
    before = at.launches["window_attention"]
    out = at.window_attention(q, ck, cv, pos)
    again = at.window_attention(q, ck, cv, pos)
    ref = at.window_attention_plain(q, ck, cv, pos)
    torch.cuda.synchronize()
    assert at.launches["window_attention"] == before + 2
    dname = str(dtype).replace("torch.", "")
    assert cs.row_ratio(torch, out, at.window_attention_plain,
                        (q, ck, cv, pos), dname) <= 1.0
    bar = _bf16_bar(ref) if dtype != torch.float32 else 1e-5 * max(
        1.0, ref.abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= bar
    assert torch.equal(out, again)


B8_GEMV_CASES = [(m, k, n, 0) for m in cs.B8_GEMV_M
                 for k, n in cs.B8_PAIRS] + [
    (m, k, n, off) for m in (1, 9) for k, n, off in
    ((1000, 4096, 0), (4096, 999, 0), (4096, 4096, 1))]


@pytest.mark.parametrize("m,k,n,w_off", B8_GEMV_CASES)
def test_gemv_kernel_edges_on_card(cuda, m, k, n, w_off):
    """B8's bf16 GEMV at every decode M with the four decode (K, N), a K
    tail, N off the vector gate and a weight 1 byte off 16-byte alignment:
    each output row within its bar of the plain version in f32, the whole
    within the bar of the plain version, a second call bit-identical, one
    launch on the GEMV route."""
    x, w, s = cs.matmul_case(torch, cuda, torch.bfloat16, m, k, n)
    if w_off:
        w = cs.b8_offset_w(torch, w)
    before = dict(qm.launches)
    out = qm.weight_only_matmul(x, w, s)
    ref = qm.dequant_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert {key: qm.launches[key] - before[key] for key in before} == {
        "weight_only_matmul": 1, "weight_only_matmul_prefill": 0,
        "weight_only_matmul_offgate": 0}
    assert cs.row_ratio(torch, out, qm.dequant_matmul_plain, (x, w, s),
                        "bfloat16") <= 1.0
    assert (out.float() - ref.float()).abs().max().item() <= _bf16_bar(ref)
    assert torch.equal(qm.weight_only_matmul(x, w, s), out)


def test_gemv_bar_rejects_planted_faults_on_card(cuda):
    """The per-row bar at a GEMV shape with a K tail rejects each planted
    B8 fault, the dropped K tail and the scales off by one channel among
    them."""
    x, w, s = cs.matmul_case(torch, cuda, torch.bfloat16, 8, 1000, 4096)
    for fault, wrong, right in cs.planted_b8_faults(torch, qm, x, w, s):
        assert cs.flash_row_ratio(torch, wrong, right,
                                  cs.TOL["bfloat16"]) > 1.0, fault


# B8 bf16 on each route at its tile edges: (m, k, n, the route it must
# take, x shifted 2 bytes off 16-byte alignment)
B8_ROUTE_CASES = [(m, k, n, "tma", False) for m in cs.B8_EDGE_M
                  for k, n in ((4096, 4096), (4096, 11008))] + [
    (333, 1000, 1008, "tma", False), (300, 1001, 4096, "mma", False),
    (100, 520, 300, "mma", False), (512, 4096, 4096, "mma", True)]


@pytest.mark.parametrize("m,k,n,want,offset", B8_ROUTE_CASES)
def test_weight_only_matmul_routes_on_card(cuda, m, k, n, want, offset):
    """The TMA + wgmma kernel on the gate, the wmma tiles off it, each
    within the bf16 bar of the plain version; the counters say which
    kernel ran."""
    x, w, s = cs.matmul_case(torch, cuda, torch.bfloat16, m, k, n)
    if offset:
        x = cs.b8_offset_x(torch, x)
    assert qm.route(m, k, n, x.dtype, x.data_ptr(), w.data_ptr()) == want
    before = dict(qm.launches)
    out = qm.weight_only_matmul(x, w, s)
    ref = qm.dequant_matmul_plain(x, w, s)
    torch.cuda.synchronize()
    assert {key: qm.launches[key] - before[key] for key in before} == {
        "weight_only_matmul": 1,
        "weight_only_matmul_prefill": int(want == "tma"),
        "weight_only_matmul_offgate": int(want == "mma")}
    assert torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= _bf16_bar(ref)


def test_weight_only_matmul_bar_rejects_planted_faults_on_card(cuda):
    x, w, s = cs.matmul_case(torch, cuda, torch.bfloat16, 512, 4096, 4096)
    for fault, wrong, right in cs.planted_b8_faults(torch, qm, x, w, s):
        err = (wrong.float() - right.float()).abs().max().item()
        assert err > _bf16_bar(right), fault


def test_quantized_kernel_checks_on_card(cuda):
    x = torch.randn(4, 64, device=cuda)
    w, s = qm.quantize_absmax(torch.randn(64, 32, device=cuda))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        qm.weight_only_matmul(x.half(), w, s)
    with pytest.raises(ValueError, match="contiguous"):
        qm.weight_only_matmul(x, w.t().contiguous().t(), s)
    with pytest.raises(TypeError, match="float32"):
        qm.weight_only_matmul(x, w, s.double())
    # the C entry point refuses the TMA route for a shape it cannot take
    xb = torch.randn(64, 1001, device=cuda).to(torch.bfloat16)
    wb, sb = qm.quantize_absmax(torch.randn(1001, 64, device=cuda))
    out = torch.empty(64, 64, dtype=torch.bfloat16, device=cuda)
    lib = qm._build.lib("quantized_matmul")
    for k_, tile in ((1001, 256), (1000, 64)):
        rc = lib.pt_weight_only_matmul(
            xb.data_ptr(), wb.data_ptr(), sb.data_ptr(), out.data_ptr(), 0,
            64, k_, 64, k_, 1, 1, 1, 128, tile,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 1   # cudaErrorInvalidValue
    g = torch.Generator(device=cuda).manual_seed(3)
    pk, sk = _q8_pool(g, cuda, 5, 2, 8, 128)
    q = torch.randn(2, 1, 4, 128, device=cuda)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    pos = torch.tensor([3, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        at.paged_decode_attention(q.double(), pk, pk, bt, pos, k_scale=sk,
                                  v_scale=sk)
    with pytest.raises(ValueError, match="contiguous"):
        at.paged_decode_attention(q, pk.transpose(2, 3).contiguous()
                                  .transpose(2, 3), pk, bt, pos, k_scale=sk,
                                  v_scale=sk)
    pk96, sk96 = _q8_pool(g, cuda, 5, 2, 8, 96)
    with pytest.raises(ValueError, match="head_dim"):
        at.paged_decode_attention(torch.randn(2, 1, 4, 96, device=cuda),
                                  pk96, pk96, bt, pos, k_scale=sk96,
                                  v_scale=sk96)


# B1-B3 at the shapes of chip_smoke.py's parity phase:
# (b, sq, sk, h, hk, d, causal, dtype)
FLASH_SHAPES = [
    (2, 2048, 2048, 32, 32, 128, True, torch.bfloat16),
    (1, 1024, 1024, 32, 8, 128, True, torch.bfloat16),
    (1, 1024, 1024, 16, 16, 128, False, torch.bfloat16),
    (2, 384, 1024, 8, 8, 128, True, torch.bfloat16),
    (1, 1000, 1000, 8, 4, 128, True, torch.bfloat16),
    (1, 1000, 300, 8, 8, 128, True, torch.bfloat16),
    (2, 777, 777, 4, 2, 64, True, torch.bfloat16),
    (2, 129, 127, 4, 2, 128, True, torch.bfloat16),
    (1, 129, 127, 4, 4, 64, False, torch.bfloat16),
    # the backward's tile edges: Sq, Sk off the 128- and 64-row tiles, a GQA
    # group of 8, rows past Sk without the causal mask
    (1, 192, 320, 8, 2, 128, True, torch.bfloat16),
    (1, 65, 129, 4, 4, 64, True, torch.bfloat16),
    (1, 256, 256, 8, 1, 128, True, torch.bfloat16),
    (1, 300, 200, 8, 4, 128, False, torch.bfloat16),
    (1, 512, 512, 4, 2, 128, True, torch.float32),
    (1, 300, 200, 4, 4, 64, False, torch.float32),
    (1, 300, 100, 4, 2, 128, True, torch.float32),
]


def _flash_inputs(cuda, b, sq, sk, h, hk, d, dtype, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    return rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d), \
        rnd(b, sq, h, d)


def _flash_ratio(got, ref, dtype):
    """chip_smoke.py's bar for B1-B3: the worst head_dim vector's error
    over 2^-6 (bf16) or 1e-5 (f32) of its own max |ref|; passes at <= 1."""
    tol = cs.TOL[str(dtype).replace("torch.", "")]
    return cs.flash_row_ratio(torch, got, ref, tol)


@pytest.mark.parametrize("b,sq,sk,h,hk,d,causal,dtype", FLASH_SHAPES)
def test_flash_kernels_match_plain_on_card(cuda, b, sq, sk, h, hk, d, causal,
                                           dtype):
    """B1, and B2 + B3 through `flash_bwd` fed the plain forward's out and
    lse; a row that sees no key (sq > sk) gives out 0, lse -1e30."""
    q, k, v, do = _flash_inputs(cuda, b, sq, sk, h, hk, d, dtype)
    before = dict(fa.launches)
    out, lse = fa.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    dq, dk, dv = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, causal)
    refs = fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do, causal)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    masked = ref_lse <= -1e29
    assert torch.equal(lse <= -1e29, masked)
    assert masked.any().item() == (sq > sk and causal)
    assert out.dtype == dq.dtype == dtype
    assert dk.dtype == dv.dtype == torch.float32
    lse, ref_lse = (torch.where(masked, 0.0, t) for t in (lse, ref_lse))
    assert cs.flash_lse_ratio(torch, lse, ref_lse) <= 1.0
    for got, ref in zip((out, dq, dk, dv), (ref_out, *refs)):
        assert torch.isfinite(got).all()
        assert _flash_ratio(got, ref, dtype) <= 1.0


@pytest.mark.parametrize("d", [128, 64])
def test_flash_backward_is_deterministic_on_card(cuda, d):
    """B2 and B3 twice on the same inputs give bit-identical dq, dk, dv (B3
    sums the GQA group in registers, in a fixed order)."""
    q, k, v, do = _flash_inputs(cuda, 2, 700, 700, 8, 2, d, torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v, True)
    first = fa.flash_bwd(q, k, v, out, lse, do, True)
    second = fa.flash_bwd(q, k, v, out, lse, do, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_autograd_round_trip_on_card(cuda):
    """flash_attention_fwd under autograd (B1 forward, B2 + B3 backward)
    against the plain versions' autograd-free composition."""
    q, k, v, do = _flash_inputs(cuda, 2, 512, 512, 8, 2, 128,
                                torch.bfloat16, seed=6)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(fa.launches)
    out = fa.flash_attention_fwd(*leaves, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_dq": 1, "flash_bwd_dkv": 1}
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, True)
    assert _flash_ratio(out, ref_out, torch.bfloat16) <= 1.0
    refs = fa.flash_bwd_plain(q, k, v, out.detach(), ref_lse, do, True)
    for t, ref in zip(leaves, refs):
        assert t.grad.dtype == torch.bfloat16
        assert _flash_ratio(t.grad, ref.to(torch.bfloat16),
                            torch.bfloat16) <= 1.0


@pytest.mark.parametrize("case", cs.FLASH_FWD_CASES, ids=lambda c: c[0])
def test_flash_fwd_fp16_and_head_dim_32_match_plain_on_card(cuda, case):
    """B1 alone in fp16 and at head_dim 32 (chip_smoke.FLASH_FWD_CASES):
    each vector within B1's bar of the plain version, lse within its bar,
    a second call bit-identical, one launch a call, counted under its
    variant too."""
    _, b, sq, sk, h, hk, d, causal, dname = case
    q, k, v, _ = _flash_inputs(cuda, b, sq, sk, h, hk, d,
                               getattr(torch, dname))
    before, vbefore = dict(fa.launches), dict(fa.variant_launches)
    out, lse = fa.flash_fwd(q, k, v, causal)
    again = fa.flash_fwd(q, k, v, causal)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    assert {n: fa.launches[n] - before[n] for n in before} == {
        "flash_fwd": 2, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert {n: fa.variant_launches[n] - vbefore[n] for n in vbefore} == {
        "flash_fwd_f16": 2 * (dname == "float16"),
        "flash_fwd_hd32": 2 * (d == 32)}
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    masked = ref_lse <= -1e29
    assert torch.equal(lse <= -1e29, masked)
    lse, ref_lse = (torch.where(masked, 0.0, t) for t in (lse, ref_lse))
    assert cs.flash_lse_ratio(torch, lse, ref_lse) <= 1.0
    assert _flash_ratio(out, ref_out, out.dtype) <= 1.0


@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 32)])
def test_grad_calls_off_b2_b3_take_the_plain_attention_on_card(cuda, dtype,
                                                               d):
    """An fp16 or head_dim-32 call that will need a gradient routes on
    B2/B3's gate before any launch: `nn.functional.flash_attention` takes
    the plain attention (no launch, a backward that runs), the
    differentiable entry point raises before B1 launches, and without a
    gradient the same call launches B1 once."""
    import paddle_tpu_torch as paddle

    q, k, v, _ = _flash_inputs(cuda, 1, 256, 256, 4, 2, d, dtype)
    leaves = [paddle.to_tensor(t, stop_gradient=False) for t in (q, k, v)]
    before = dict(fa.launches)
    out, _ = paddle.nn.functional.flash_attention(*leaves, causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    assert fa.launches == before
    assert all(torch.isfinite(t.grad._data).all() for t in leaves)
    with pytest.raises((TypeError, ValueError), match="B2/B3 takes"):
        fa.flash_attention_fwd(*(t.clone().requires_grad_()
                                 for t in (q, k, v)), causal=True)
    assert fa.launches == before
    with paddle.no_grad():
        paddle.nn.functional.flash_attention(*leaves, causal=True)
    torch.cuda.synchronize()
    assert fa.launches["flash_fwd"] == before["flash_fwd"] + 1


def test_flash_kernel_checks_on_card(cuda):
    q = torch.randn(1, 64, 4, 128, device=cuda)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        fa.flash_fwd(q.double(), q.double(), q.double())
    h = q.half()
    out, lse = fa.flash_fwd(h, h, h)
    with pytest.raises(TypeError, match="B2/B3 takes bfloat16 or float32"):
        fa.flash_bwd(h, h, h, out, lse, h)
    x = torch.randn(1, 64, 4, 32, device=cuda)
    out, lse = fa.flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="B2/B3 takes head_dim"):
        fa.flash_bwd(x, x, x, out, lse, x)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.randn(1, 64, 4, 96, device=cuda)
        fa.flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), q, q)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_fwd(q, q[:, :, :3].contiguous(), q[:, :, :3].contiguous())


def _rms_check(x, w, g, dname):
    """B9 and B10 on x, w, g against their plain versions (chip_smoke's
    bars); returns the kernels' (y, r)."""
    y, r = rn.rms_norm_fwd(x, w, cs.RMS_EPS)
    ry, rr = rn.rms_norm_fwd_plain(x, w, cs.RMS_EPS)
    dx, dw = rn.rms_norm_bwd(x, w, rr, g)
    rdx, rdw = rn.rms_norm_bwd_plain(x, w, rr, g)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dw.dtype == x.dtype
    ratios = cs.rms_ratios(torch, {"y": y, "r": r, "dx": dx, "dw": dw},
                           {"y": ry, "r": rr, "dx": rdx, "dw": rdw}, dname)
    assert max(ratios.values()) <= 1.0, ratios
    return y, r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("rows,h", [(8, 4096), (1, 128), (4097, 2048),
                                    (300, 16384), (33, 8), (700, 11008)])
def test_rms_norm_kernels_match_plain_on_card(cuda, dtype, rows, h):
    x, w, g = cs.rms_case(torch, cuda, rows, h, dtype)
    before = dict(rn.launches)
    y, _ = _rms_check(x, w, g, str(dtype).replace("torch.", ""))
    assert {k: rn.launches[k] - before[k] for k in before} == {
        "rms_norm_fwd": 1, "rms_norm_bwd": 1}
    # rows with a stride of their own (a view of a wider tensor), and no r
    wide = torch.zeros(rows, h + 8, dtype=dtype, device=cuda)
    wide[:, :h] = x
    y2, r2 = rn.rms_norm_fwd(wide[:, :h], w, cs.RMS_EPS, save_r=False)
    torch.cuda.synchronize()
    assert r2 is None and torch.equal(y, y2)


@pytest.mark.parametrize("rows,h", [(4096, 4096), (4096, 2048), (8, 4096),
                                    (4097, 4096)])
def test_rms_norm_backward_is_deterministic_on_card(cuda, rows, h):
    """B10 at the 7B and h2048 legs' micro-batches, the decode rows and a
    ragged row count: dx and dw within their bars, one launch a call, and a
    second call bit-identical, dw included (its sum over rows runs in a
    fixed order inside the launch)."""
    x, w, g = cs.rms_case(torch, cuda, rows, h, torch.bfloat16)
    _, r = rn.rms_norm_fwd_plain(x, w, cs.RMS_EPS)
    before = rn.launches["rms_norm_bwd"]
    dx, dw = rn.rms_norm_bwd(x, w, r, g)
    dx2, dw2 = rn.rms_norm_bwd(x, w, r, g)
    rdx, rdw = rn.rms_norm_bwd_plain(x, w, r, g)
    torch.cuda.synchronize()
    assert rn.launches["rms_norm_bwd"] == before + 2
    ratios = cs.rms_ratios(torch, {"dx": dx, "dw": dw},
                           {"dx": rdx, "dw": rdw}, "bfloat16")
    assert max(ratios.values()) <= 1.0, ratios
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


def test_rms_norm_bar_rejects_planted_faults_on_card(cuda):
    """chip_smoke's B9/B10 bars on the card at the 7B micro-batch: B10's dw
    split passes; each planted fault (eps, the mean over H - 1, r from
    another row, a row group or a cluster's partial left out of dw or
    counted twice) fails."""
    x, w, g = cs.rms_case(torch, cuda, 4096, 4096, torch.bfloat16)
    sms = qm._sms(cuda)
    _, r = rn.rms_norm_fwd_plain(x, w, cs.RMS_EPS)
    _, dw = rn.rms_norm_bwd_plain(x, w, r, g)
    split = cs.rms_dw_split(torch, rn, x, r, g, sms).to(w.dtype)
    assert cs.rms_ratios(torch, {"dw": split}, {"dw": dw},
                         "bfloat16")["dw"] <= 1.0
    for fault, wrong, right in cs.planted_rms_faults(torch, rn, x, w, g,
                                                     sms):
        bad = cs.rms_ratios(torch, wrong, right, "bfloat16")
        assert max(bad.values()) > 1.0, fault


def test_rms_norm_autograd_on_card(cuda):
    """`rms_norm` under autograd: B9 forward, B10 backward, against the
    plain versions."""
    x, w, g = cs.rms_case(torch, cuda, 64, 4096, torch.bfloat16)
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = dict(rn.launches)
    y = rn.rms_norm(xl.view(4, 16, 4096), wl, cs.RMS_EPS)
    y.backward(g.view(4, 16, 4096))
    torch.cuda.synchronize()
    assert {k: rn.launches[k] - before[k] for k in before} == {
        "rms_norm_fwd": 1, "rms_norm_bwd": 1}
    ry, rr = rn.rms_norm_fwd_plain(x, w, cs.RMS_EPS)
    rdx, rdw = rn.rms_norm_bwd_plain(x, w, rr, g)
    ratios = cs.rms_ratios(
        torch, {"y": y.detach().view(64, 4096), "dx": xl.grad, "dw": wl.grad},
        {"y": ry, "dx": rdx, "dw": rdw}, "bfloat16")
    assert max(ratios.values()) <= 1.0, ratios


def test_rms_norm_kernel_checks_on_card(cuda):
    x = torch.randn(4, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.ones(64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16, float16 or float32"):
        rn.rms_norm_fwd(x.double(), w.double(), 1e-6)
    with pytest.raises(TypeError, match="dtype mismatch"):
        rn.rms_norm_fwd(x.half(), w, 1e-6)
    with pytest.raises(TypeError, match="dtype mismatch"):
        rn.rms_norm_fwd(x.float(), w, 1e-6)
    with pytest.raises(ValueError, match="H % 8"):
        rn.rms_norm_fwd(x[:, :60], w[:60], 1e-6)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rn.rms_norm_fwd(torch.randn(4, 80, device=cuda,
                                    dtype=torch.bfloat16)[:, 1:65], w, 1e-6)
    with pytest.raises(ValueError, match="different devices"):
        rn.rms_norm_fwd(x, w.cpu(), 1e-6)
    r = torch.ones(4, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rn.rms_norm_bwd(x, w, r.double(), x)



@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: a launch on cuda:1 while cuda:0 is "
                    "the current device")
    return torch.device("cuda", 1)


def test_every_kernel_launches_on_its_tensors_card(second_card):
    """One launch of each kernel (B1-B10) on cuda:1 while cuda:0 is the
    current device: each agrees with its plain version there (B4-B7 past
    48 KB of shared memory, opted into on that card), and the current
    device is left as it was."""
    dev = second_card
    torch.cuda.set_device(0)
    g = torch.Generator(device=dev).manual_seed(7)
    before = cs.launch_counts()
    # B1-B3, held to chip_smoke.py's per-vector bar
    q, k, v, do = _flash_inputs(dev, 1, 256, 256, 8, 2, 128, torch.bfloat16)
    out, lse = fa.flash_fwd(q, k, v, True)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, True)
    grads = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, True)
    refs = fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do, True)
    flash = [(out, ref_out)] + list(zip(grads, refs))
    # B4-B7: 64 query rows per kv head (the most shared memory), int8 too
    b, nh, nkv, hd, ps, P = 2, 64, 1, 128, 16, 8
    n_pages = 1 + b * P
    pk, pv = (torch.randn(n_pages, nkv, ps, hd, generator=g, device=dev)
              .to(torch.bfloat16) for _ in range(2))
    kq, ks = _q8_pool(g, dev, n_pages, nkv, ps, hd)
    bt = (torch.arange(b * P, device=dev) + 1).reshape(b, P).to(torch.int32)
    pos = torch.tensor([100, 37], dtype=torch.int32, device=dev)
    qd = torch.randn(b, 1, nh, hd, generator=g, device=dev).to(torch.bfloat16)
    ck, cv = at.paged_gather(pk, bt), at.paged_gather(pv, bt)
    plain = [(at.decode_attention(qd, ck, cv, pos),
              at.decode_attention_plain(qd, ck, cv, pos)),
             (at.window_attention(qd, ck, cv, pos),
              at.window_attention_plain(qd, ck, cv, pos)),
             (at.paged_decode_attention(qd, pk, pv, bt, pos),
              at.paged_decode_attention_plain(qd, pk, pv, bt, pos)),
             (at.paged_decode_attention(qd, kq, kq, bt, pos, k_scale=ks,
                                        v_scale=ks),
              at.paged_decode_attention_plain(qd, kq, kq, bt, pos,
                                              k_scale=ks, v_scale=ks))]
    # B8 on its GEMV and TMA routes
    w, s = qm.quantize_absmax(
        torch.randn(512, 1024, generator=g, device=dev) * 0.02)
    for m in (8, 256):
        x = torch.randn(m, 512, generator=g, device=dev).to(torch.bfloat16)
        plain.append((qm.weight_only_matmul(x, w, s),
                      qm.dequant_matmul_plain(x, w, s)))
    # B9, B10
    xn, wn, gn = cs.rms_case(torch, dev, 64, 4096, torch.bfloat16)
    _rms_check(xn, wn, gn, "bfloat16")
    torch.cuda.synchronize(dev)
    assert torch.cuda.current_device() == 0
    after = cs.launch_counts()
    assert {n for n in after if after[n] > before[n]} >= {
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "decode_attention",
        "window_attention", "paged_decode_attention",
        "paged_decode_attention_int8", "weight_only_matmul",
        "weight_only_matmul_prefill", "rms_norm_fwd", "rms_norm_bwd"}
    for got, ref in flash + plain:
        assert got.device == dev and torch.isfinite(got).all()
    for got, ref in flash:
        assert _flash_ratio(got, ref, torch.bfloat16) <= 1.0
    for got, ref in plain:
        assert (got.float() - ref.float()).abs().max().item() <= \
            _bf16_bar(ref)


def test_bf16_rows_do_not_depend_on_their_batch_on_card(cuda):
    """Fault C2: `chip_smoke.phase_c2` on the card: one row through B4,
    B5, B6 and B7 in bf16 and in fp16 gives the same bits alone, among 7
    rows with the
    batch's max_pos and among 3 with pos on the card, at 7B's and GPT-2's
    decode shapes; one x row through B8's GEMV the same bits at M = 1, 8,
    9 and 16."""
    assert cs.phase_c2(torch, cuda) == []


def test_b10_on_two_streams_gives_solo_bits_on_card(cuda):
    """Fault C3: `chip_smoke.phase_c3` on the card: B10 calls on two
    streams at once each give the bits they give alone."""
    assert not any(cs.phase_c3(torch, cuda, calls=16).values())


def _traced_cases(dev):
    """B4-B7 at 7B's decode heads (32 of 128, bf16) over ragged rows:
    (name, wrapper, args, kwargs)."""
    g = torch.Generator(device=dev).manual_seed(11)
    b, nh, hd, ps, P, length = 4, 32, 128, 16, 32, 512

    def t(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    pos = torch.tensor([511, 0, 100, 257], dtype=torch.int32, device=dev)
    pages = 1 + b * P
    bt = (torch.randperm(pages - 1, generator=g, device=dev) + 1).reshape(
        b, P).to(torch.int32)
    codes = [torch.randint(-127, 128, (pages, nh, ps, hd), generator=g,
                           device=dev, dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand((pages, nh), generator=g, device=dev) + 0.5
              for _ in range(2)]
    return [
        ("decode_attention", at.decode_attention,
         (t(b, 1, nh, hd), t(b, nh, length, hd), t(b, nh, length, hd), pos),
         {}),
        ("window_attention", at.window_attention,
         (t(b, 2, nh, hd), t(b, nh, length, hd), t(b, nh, length, hd),
          pos.clamp(max=length - 2)), {}),
        ("paged_decode_attention", at.paged_decode_attention,
         (t(b, 1, nh, hd), t(pages, nh, ps, hd), t(pages, nh, ps, hd), bt,
          pos), {"max_pos": 511}),
        ("paged_decode_attention_int8", at.paged_decode_attention,
         (t(b, 1, nh, hd), *codes, bt, pos),
         {"k_scale": scales[0], "v_scale": scales[1], "max_pos": 511}),
    ]


def test_traced_decode_operators_launch_with_eager_bits_on_card(cuda):
    """B4-B7 as operators: a make_fx trace over fake CUDA tensors holds one
    node each and launches nothing; the graph run on the card launches the
    kernel once, with the split count fixed at trace time, and gives the
    eager wrapper's bits."""
    from torch.fx.experimental.proxy_tensor import make_fx

    for name, fn, args, kw in _traced_cases(cuda):
        eager = fn(*args, **kw)
        # every tensor is an input of the trace (the int8 pool's scales too)
        scales = tuple(v for v in kw.values() if torch.is_tensor(v))
        static = {k: v for k, v in kw.items() if not torch.is_tensor(v)}
        n = len(args)

        def call(*a, fn=fn, static=static, n=n):
            extra = dict(zip(("k_scale", "v_scale"), a[n:]))
            return fn(*a[:n], **extra, **static)

        args = args + scales
        at.reset_launches()
        gm = make_fx(call, tracing_mode="fake")(*args)
        assert not any(at.launches.values()), name
        nodes = [n for n in gm.graph.nodes if n.op == "call_function"
                 and str(n.target).startswith("paddle_tpu_torch.")]
        assert len(nodes) == 1, (name, nodes)
        got = gm(*args)
        torch.cuda.synchronize(cuda)
        assert at.launches[name] == 1, (name, dict(at.launches))
        assert torch.equal(got, eager), name


def test_real_mode_trace_raises_at_a_kernel_launch_on_card(cuda):
    """make_fx in real mode over CUDA tensors would record an empty buffer
    in place of a kernel's output: the launch raises instead (B4 through
    its wrapper, B9 without a gradient to take)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    name, fn, args, kw = _traced_cases(cuda)[0]
    with pytest.raises(RuntimeError, match="proxy tracer"):
        make_fx(lambda q, k, v, pos: fn(q, k, v, pos))(*args)
    x = torch.randn(64, 4096, device=cuda, dtype=torch.bfloat16)
    w = torch.ones(4096, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad(), pytest.raises(RuntimeError, match="proxy tracer"):
        make_fx(lambda x, w: rn.rms_norm(x, w, 1e-6))(x, w)
