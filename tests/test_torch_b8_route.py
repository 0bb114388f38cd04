"""Kernel B8's route rule (`quantized_matmul.route`, `tile`), on the CPU.

The rule picks B8's kernel from the shape, x's dtype and the data pointers
before the launch: the GEMV for M <= 16, the CUDA-core tiles for f32, the
TMA + wgmma kernel where a TMA copy can read both operands (K % 8 == 0,
N % 16 == 0, x and w 16-byte aligned), the wmma tiles for every other bf16
shape. The kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py); here the rule is pure Python. The last
test drives `generation`'s real `_wmm` call sites at Llama-2-7B width on
the meta device (no memory, no arithmetic) and checks the route of every
B8 shape they make.
"""

import pytest
import torch

from paddle_tpu_torch.kernels import quantized_matmul as qm
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.llama_functional import LLAMA2_7B

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("m,k,n,dtype,x_ptr,w_ptr,want", [
    # the M <= 16 GEMV split, whatever the rest
    (1, 4096, 4096, BF16, 0, 0, "gemv"),
    (16, 4096, 11008, BF16, 0, 0, "gemv"),
    (16, 1001, 999, F32, 2, 3, "gemv"),
    (17, 4096, 11008, BF16, 0, 0, "tma"),
    # f32 above 16 rows: the CUDA-core kernel, aligned or not
    (17, 4096, 4096, F32, 0, 0, "simt"),
    (2048, 4096, 11008, F32, 0, 0, "simt"),
    # K % 8, N % 16
    (512, 4100, 4096, BF16, 0, 0, "mma"),
    (512, 4104, 4096, BF16, 0, 0, "tma"),
    (512, 4096, 4104, BF16, 0, 0, "mma"),
    (512, 4096, 4112, BF16, 0, 0, "tma"),
    (333, 1000, 1008, BF16, 0, 0, "tma"),
    # alignment of either pointer
    (512, 4096, 4096, BF16, 2, 0, "mma"),
    (512, 4096, 4096, BF16, 8, 0, "mma"),
    (512, 4096, 4096, BF16, 16 * 1001, 0, "tma"),
    (512, 4096, 4096, BF16, 0, 4, "mma"),
    (512, 4096, 4096, BF16, 0, 32, "tma"),
])
def test_route_rule(m, k, n, dtype, x_ptr, w_ptr, want):
    assert qm.route(m, k, n, dtype, x_ptr, w_ptr) == want


@pytest.mark.parametrize("m,n,want", [
    # 688 tiles of 256 x 128: 6 waves of 132; 1376 of 128 x 128: 11 at
    # 0.72 of the time each
    (2048, 11008, (256, 128)),
    (2048, 4096, (256, 128)),
    (1500, 11008, (256, 128)),
    (1500, 4096, (256, 128)),    # 2 waves against 3 x 0.72
    (512, 4096, (128, 128)),     # 64 large tiles would leave half idle
    (512, 11008, (256, 128)),
    (333, 1008, (128, 128)),
    (17, 32000, (128, 256)),     # 125 such tiles: one wave; 250 others
])
def test_tile_fills_the_card(m, n, want):
    assert qm.tile(m, n, 132) == want


@pytest.mark.parametrize("m", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096),
                                 (4096, 32000), (1000, 999), (16, 8),
                                 (130, 520)])
@pytest.mark.parametrize("sms", [132, 114])
def test_gemv_split_covers_the_weight(m, k, n, sms):
    """The bf16 GEMV's grid, (N / 128 column tiles, a cluster of blocks
    over K): the blocks of a cluster interleave their k16 steps (step j of
    warp w of block r is K rows 16 ((j R + r) 8 + w)), so together they
    take every k16 step of K exactly once, each block at most `per` rows
    and every block at least one step a warp; the cluster is a power of
    two, stays portable (<= 8) and keeps the grid within 4/3 of a block
    an SM whenever it is split at all. The split is the same at every M
    of a decode batch (it does not read M)."""
    per, ranks = qm.gemv_split(k, n, sms)
    tiles = -(-n // qm.GEMV_COLS)
    assert tiles * qm.GEMV_COLS >= n
    assert ranks in (1, 2, 4, 8) and ranks <= qm.GEMV_MAX_CLUSTER
    assert ranks == 1 or tiles * ranks <= 4 * sms // 3
    steps = -(-k // 16)
    assert ranks == 1 or 8 * ranks <= steps
    assert per * ranks >= k
    taken = []
    for r in range(ranks):
        mine = [s for w in range(8) for j in range(steps)
                if (s := (j * ranks + r) * 8 + w) < steps]
        assert 0 < 16 * len(mine) <= per
        taken += mine
    assert sorted(taken) == list(range(steps))


@pytest.mark.parametrize("m,k,n,want", [
    # the fastest cluster of kernels/sweep_decode.py at 8 rows on an H100
    # (132 SMs); every M takes 8 rows' cluster, so that a row's K sums do
    # not depend on the batch
    (8, 4096, 4096, 4), (8, 4096, 11008, 2), (8, 11008, 4096, 4),
    (8, 4096, 32000, 1), (1, 4096, 4096, 4), (1, 4096, 11008, 2),
    (16, 4096, 4096, 4), (16, 4096, 11008, 2), (16, 11008, 4096, 4),
    (16, 4096, 32000, 1)])
def test_gemv_split_at_the_decode_shapes(m, k, n, want):
    assert qm.gemv_split(k, n, 132)[1] == want


# prompt, chunk and batched-prefill rows of the serving path: the engine's
# 24-token prompt through 2048, chunks of 256, generate's b=4 prompts
PREFILL_ROWS = (17, 24, 64, 192, 256, 512, 1500, 2048)
DECODE_ROWS = (1, 4, 8, 16)


def test_every_7b_matmul_of_the_serving_path_takes_the_tma_route(
        monkeypatch):
    """Every `_wmm` call site (QKV, the FFN, the output projection, the
    head) at Llama-2-7B width, with prefill rows above 16: the TMA route;
    decode rows: the GEMV. x comes from a fresh allocation, which the
    allocator aligns to far more than 16 bytes."""
    args = LLAMA2_7B
    hid, inter, vocab = args.hidden_size, args.intermediate_size, \
        args.vocab_size
    meta = torch.device("meta")

    def qw(k, n):
        return tgen.QuantizedWeight(
            torch.empty(k, n, dtype=torch.int8, device=meta),
            torch.empty(n, dtype=torch.float32, device=meta))

    kv = args.num_kv_heads * args.head_dim
    lp = {"ln1": torch.empty(hid, device=meta),
          "ln2": torch.empty(hid, device=meta),
          "wq": qw(hid, args.num_heads * args.head_dim), "wk": qw(hid, kv),
          "wv": qw(hid, kv), "wo": qw(args.num_heads * args.head_dim, hid),
          "w_gate": qw(hid, inter), "w_up": qw(hid, inter),
          "w_down": qw(inter, hid)}
    head = qw(hid, vocab)
    seen = []

    def record(x, w_q, scale, out_dtype=None):
        k, n = w_q.shape
        m = x.reshape(-1, k).shape[0]
        seen.append((m, k, n, qm.route(m, k, n, x.dtype, 0, 0)))
        return torch.empty(*x.shape[:-1], n, dtype=out_dtype or x.dtype,
                           device=x.device)

    monkeypatch.setattr(tgen.qmm, "weight_only_matmul", record)
    monkeypatch.setattr(tgen.lf, "rms_norm", lambda x, w, eps: x)
    for rows in PREFILL_ROWS + DECODE_ROWS:
        b, s = (4, rows // 4) if rows in (192,) else (1, rows)
        h = torch.empty(b, s, hid, dtype=BF16, device=meta)
        tgen._qkv(lp, h, args)
        tgen._mlp_block(lp, h, args)
        tgen._wmm(h, lp["wo"])
        tgen._wmm(h, head)
    shapes = {(k, n) for _, k, n, _ in seen}
    assert shapes == {(hid, hid), (hid, inter), (inter, hid), (hid, vocab)}
    for m, k, n, way in seen:
        assert way == ("gemv" if m <= qm.GEMV_MAX_ROWS else "tma"), \
            (m, k, n, way)
    assert {m for m, *_ in seen} == set(PREFILL_ROWS + DECODE_ROWS)
