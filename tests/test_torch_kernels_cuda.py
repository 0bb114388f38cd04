"""Kernels B4-B8 of the PyTorch port on an NVIDIA card: each kernel
agrees with its plain PyTorch version on the same inputs, counts its
launches, and rejects what it does not take. Marked `cuda`; the tests skip
where there is no card. This file imports neither JAX nor the reference
package, so the card's machine runs it without them:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from paddle_tpu_torch.kernels import attention as at
from paddle_tpu_torch.kernels import quantized_matmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a card")
    return torch.device("cuda")


def _bf16_bar(ref):
    # two bf16 units in the last place at the largest output: the plain
    # version rounds its scores and probabilities to bf16, the kernel not
    return 2.0 ** -6 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nkv,hd", [(8, 128), (2, 128), (4, 64)])
def test_kernels_match_plain_on_card(cuda, dtype, nkv, hd):
    g = torch.Generator(device=cuda).manual_seed(0)
    b, nh, ps, P = 4, 8, 16, 16
    n_pages = 1 + b * P

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    pk, pv = rnd(n_pages, nkv, ps, hd), rnd(n_pages, nkv, ps, hd)
    bt = (torch.randperm(n_pages - 1, generator=g, device=cuda) + 1) \
        .reshape(b, P).to(torch.int32)
    pos = torch.tensor([255, 100, 0, 17], dtype=torch.int32, device=cuda)
    q = rnd(b, 1, nh, hd)
    ck, cv = at.paged_gather(pk, bt), at.paged_gather(pv, bt)
    # the widest window the kernel takes; row 0's overhangs the cache end
    qw = rnd(b, 64 // (nh // nkv), nh, hd)
    before = dict(at.launches)
    pairs = [(at.paged_decode_attention(q, pk, pv, bt, pos),
              at.paged_decode_attention_plain(q, pk, pv, bt, pos)),
             (at.decode_attention(q, ck, cv, pos),
              at.decode_attention_plain(q, ck, cv, pos)),
             (at.window_attention(qw, ck, cv, pos + 200),
              at.window_attention_plain(qw, ck, cv, pos + 200))]
    torch.cuda.synchronize()
    for out, ref in pairs:
        # f32: both sum in f32, in different orders
        bar = _bf16_bar(ref) if dtype == torch.bfloat16 else 1e-5
        assert (out.float() - ref.float()).abs().max().item() <= bar
    assert {k: at.launches[k] - before[k] for k in before} == {
        "decode_attention": 1, "window_attention": 1,
        "paged_decode_attention": 1, "paged_decode_attention_int8": 0}


def test_kernel_checks_on_card(cuda):
    q = torch.randn(2, 1, 4, 128, device=cuda)
    ck = torch.randn(2, 2, 64, 128, device=cuda)
    pos = torch.tensor([3, 4], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        at.decode_attention(q.half(), ck.half(), ck.half(), pos)
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


def _q8_pool(g, cuda, n_pages, nkv, ps, hd):
    codes = torch.randint(-127, 128, (n_pages, nkv, ps, hd), generator=g,
                          device=cuda, dtype=torch.int8)
    return codes, torch.rand(n_pages, nkv, generator=g, device=cuda) + 0.5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nkv,hd,ps", [(8, 128, 16), (2, 128, 64), (4, 64, 8),
                                       (8, 128, 32)])
def test_paged_q8_kernel_matches_plain_on_card(cuda, dtype, nkv, hd, ps):
    """B7: ragged rows, pages of 8-64 (a 64-key tile spans up to 8 pages,
    each with its own scale), GQA, a page with scale 0."""
    g = torch.Generator(device=cuda).manual_seed(1)
    b, nh, P = 4, 8, 256 // ps
    n_pages = 1 + b * P
    pk, sk = _q8_pool(g, cuda, n_pages, nkv, ps, hd)
    pv, sv = _q8_pool(g, cuda, n_pages, nkv, ps, hd)
    bt = (torch.randperm(n_pages - 1, generator=g, device=cuda) + 1) \
        .reshape(b, P).to(torch.int32)
    sk[bt[1, 0]] = 0.0
    sv[bt[1, 0]] = 0.0
    pos = torch.tensor([255, 100, 0, 17], dtype=torch.int32, device=cuda)
    q = torch.randn(b, 1, nh, hd, generator=g, device=cuda).to(dtype)
    before = at.launches["paged_decode_attention_int8"]
    out = at.paged_decode_attention(q, pk, pv, bt, pos, k_scale=sk,
                                    v_scale=sv)
    ref = at.paged_decode_attention_plain(q, pk, pv, bt, pos, k_scale=sk,
                                          v_scale=sv)
    torch.cuda.synchronize()
    assert at.launches["paged_decode_attention_int8"] == before + 1
    # f32: both dequantize in f32 and sum in f32, in different orders
    bar = _bf16_bar(ref) if dtype == torch.bfloat16 else 1e-5
    assert torch.isfinite(out).all()
    assert (out.float() - ref.float()).abs().max().item() <= bar


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


def test_quantized_kernel_checks_on_card(cuda):
    x = torch.randn(4, 64, device=cuda)
    w, s = qm.quantize_absmax(torch.randn(64, 32, device=cuda))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        qm.weight_only_matmul(x.half(), w, s)
    with pytest.raises(ValueError, match="contiguous"):
        qm.weight_only_matmul(x, w.t().contiguous().t(), s)
    with pytest.raises(TypeError, match="float32"):
        qm.weight_only_matmul(x, w, s.double())
    g = torch.Generator(device=cuda).manual_seed(3)
    pk, sk = _q8_pool(g, cuda, 5, 2, 8, 128)
    q = torch.randn(2, 1, 4, 128, device=cuda)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=cuda)
    pos = torch.tensor([3, 9], dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        at.paged_decode_attention(q.half(), pk, pk, bt, pos, k_scale=sk,
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
