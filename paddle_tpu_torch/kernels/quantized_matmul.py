"""Weight-only int8 matmul: the wrapper of kernel B8 and its plain PyTorch
version, and the absmax quantizer every int8 weight goes through.

  B8  `weight_only_matmul`  replaces `_dqmm_kernel` (:101, launched by
      `fused_dequant_matmul` :135, dispatched by `weight_only_matmul` :224)

(in paddle_tpu/kernels/quantized_matmul.py)

Convention (`quantize_absmax`, :202): a weight [..., K, N] becomes int8
codes q [..., K, N] and a per-output-channel scale [..., N] f32 with
dequant = q * scale / 127.

The wrapper routes by device, as the attention wrappers do: a CPU tensor
goes to `dequant_matmul_plain` (the reference's `_dequant_matmul_xla`:
dequantize into x's dtype, then `@`), a CUDA tensor to the hand-written
kernels in `csrc/quantized_matmul.cu`, checked first; nothing falls back.
The kernels keep the weight int8 in device memory, widen it on the chip and
apply scale / 127 once per output in the epilogue. `route` picks the kernel
from the shape, the dtype and the pointers' alignment before the launch
(the C entry point refuses a route the shape does not fit):

  "gemv"  M <= 16: each int8 byte streamed once. bf16 x: tensor-core
          products, K split over the blocks of one cluster (`gemv_split`)
          that sum their partials in a fixed order in the same launch; f32
          x: the CUDA-core GEMV, split over K across blocks when the grid
          would be too small (the wrapper allocates the f32 partial sums, a
          second launch of the same library reduces them in a fixed order);
  "tma"   M > 16, bf16 x, K % 8 == 0, N % 16 == 0, x and w 16-byte aligned
          (what a TMA copy needs): TMA ring + wgmma, the output tile
          from the block tuner (`tuned_tile`: an env pin, the disk
          cache, a measurement of TILES, else `tile`'s rule);
  "mma"   M > 16, bf16 x, any other shape: wmma tiles (off the gate);
  "simt"  M > 16, f32 x: 64x64 tiles on the CUDA cores in f32 (f32
          activations are a check of the arithmetic, not the serving path).

`weight_only_matmul_op` is the same call as one custom operator,
`paddle_tpu_torch::weight_only_matmul` (B1's pattern in
`flash_attention.py`): `torch.export` keeps it as one node of the graph
(`register_fake` gives its output's shape), and its body, the wrapper
above with its route, alignment check and tile tuner, runs at every call
of the exported program, on the device the tensors are on then. Its
backward is plain PyTorch (x and the scale; the codes take none). The
functional serving path calls the wrapper directly.

`launches["weight_only_matmul"]` counts every launch of the kernel;
`launches["weight_only_matmul_prefill"]` the "tma" ones and
`launches["weight_only_matmul_offgate"]` the "mma" ones among them.
"""

from __future__ import annotations

import torch

from paddle_tpu_torch.kernels import _build, tuning

__all__ = ["quantize_absmax", "dequant_matmul_plain", "weight_only_matmul",
           "weight_only_matmul_op", "WEIGHT_ONLY_MATMUL_OP", "route", "tile",
           "tuned_tile", "TILES", "launches", "reset_launches",
           "GEMV_MAX_ROWS", "GEMV_COLS", "gemv_split"]

GEMV_MAX_ROWS = 16
# the bf16 GEMV: output columns a block covers, blocks a cluster at most
# (portable), warps a block (one k16 step each in every turn of 128 rows)
GEMV_COLS = 128
GEMV_MAX_CLUSTER = 8
_GEMV_WARPS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the split over K aims for this many blocks per SM (two waves)
_WAVES = 2
_MIN_K_PER_SPLIT = 512

_ROUTES = {"gemv": 0, "tma": 1, "mma": 2, "simt": 3}

launches = {"weight_only_matmul": 0, "weight_only_matmul_prefill": 0,
            "weight_only_matmul_offgate": 0}
_sm_count = {}


def reset_launches():
    for k in launches:
        launches[k] = 0


def quantize_absmax(w):
    """Per-output-channel absmax int8 quantization of w [..., K, N]:
    (q int8 [..., K, N], scale f32 [..., N]), dequant = q * scale / 127.
    The reference's arithmetic: f32, scale floored at 1e-9, x / scale *
    127 rounded half to even, clipped to [-127, 127]."""
    a = w.float()
    scale = a.abs().amax(dim=-2).clamp_min(1e-9)
    q = torch.round(a / scale.unsqueeze(-2) * 127.0).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequant_matmul_plain(x, w_q, scale, out_dtype=None):
    """B8's plain version (`_dequant_matmul_xla`): dequantize into x's
    dtype (scale / 127 rounded to that dtype first, as the reference
    does), then matmul."""
    wf = w_q.to(x.dtype) * (scale.to(x.dtype) / 127.0)
    out = x @ wf
    return out.to(out_dtype) if out_dtype is not None else out


def route(m, k, n, dtype, x_ptr=0, w_ptr=0):
    """The kernel a call takes, from its shape, x's dtype and the data
    pointers of x and w: "gemv", "tma", "mma" or "simt" (module doc)."""
    if m <= GEMV_MAX_ROWS:
        return "gemv"
    if dtype == torch.float32:
        return "simt"
    if k % 8 == 0 and n % 16 == 0 and x_ptr % 16 == 0 and w_ptr % 16 == 0:
        return "tma"
    return "mma"


# the TMA route's output tiles (rows, columns), and the time one takes
# against a 256 x 128 tile's (kernels/sweep_b8.py on an H100, at the
# serving shapes): a 128 x 256 tile widens twice the codes a product
# needs, a 128 x 128 tile does half the work with narrower wgmma products
TILES = {(256, 128): 1.0, (128, 256): 1.13, (128, 128): 0.72}


def tile(m, n, sms):
    """(rows, columns) of the "tma" route's output tile: the one that ends
    the grid soonest, counting whole waves of `sms` blocks; the first of
    TILES on a tie."""
    def cost(rc):
        tiles = -(-m // rc[0]) * -(-n // rc[1])
        return -(-tiles // sms) * TILES[rc]

    return min(TILES, key=cost)


def tuned_tile(m, k, n, dtype, device, measure=None):
    """The "tma" route's output tile through the block tuner
    (`tuning.get_blocks("b8_tile", {m, k, n}, ...)`): a PADDLE_TUNE_BLOCKS
    pin, the disk cache of this card, a measurement of the TILES
    candidates (PADDLE_KERNEL_AUTOTUNE=1 on a card: `measure(blocks) ->
    seconds`), else `tile`'s rule, which is therefore the pick with no env
    and no cache. A pick off TILES raises."""
    rule = tile(m, n, _sms(device))
    rule = {"tile_m": rule[0], "tile_n": rule[1]}
    got = tuning.get_blocks(
        "b8_tile", {"m": m, "k": k, "n": n}, dtype, rule, measure=measure,
        candidates=[{"tile_m": a, "tile_n": b} for a, b in TILES],
        fallback=rule, device=device)
    pick = (got["tile_m"], got["tile_n"])
    if pick not in TILES:
        raise ValueError(f"b8_tile {pick} is not one of TILES {list(TILES)}")
    return pick


def _sms(device):
    if device not in _sm_count:
        _sm_count[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_count[device]


def gemv_split(k, n, sms):
    """(K rows a block, blocks a cluster) of the bf16 GEMV: the largest
    power-of-two cluster, at most GEMV_MAX_CLUSTER blocks and at least one
    k16 step a warp, whose N / 128 column tiles times the cluster stay
    within 4/3 of a block an SM. It does not read M: the cluster sets the
    order in which a row's K partials are summed, so every M <= 16 takes
    one cluster and a row's bf16 result does not depend on the rows beside
    it. At 8 rows on an H100 that is the fastest cluster size of
    `kernels/sweep_decode.py`, which also showed a cluster of 3 slower
    than 2 or 4 (above 8 rows a block takes the registers of two). The
    blocks of a cluster take turns of 8 k16 steps (one a warp, 128 rows)
    in rank order; the K rows a block are at most 128 times its turns."""
    tiles = -(-n // GEMV_COLS)
    steps = -(-k // 16)
    limit = 4 * sms // 3
    ranks = 1
    while (ranks * 2 <= GEMV_MAX_CLUSTER and tiles * ranks * 2 <= limit
           and _GEMV_WARPS * ranks * 2 <= steps):
        ranks *= 2
    turn = 16 * _GEMV_WARPS
    return turn * -(-steps // (_GEMV_WARPS * ranks)), ranks


def _k_split(k, n, device):
    """(rows of K per block, number of splits) for the f32 GEMV. It does not
    read M (a block covers 128 output columns up to 8 rows of x, 64 above):
    the splits set the order of a row's K sums, so every M <= 16 takes the
    same, that of 128-column blocks."""
    blocks_n = -(-n // 128)
    want = -(-_WAVES * _sms(device) // blocks_n)
    splits = max(1, min(want, k // _MIN_K_PER_SPLIT))
    per = -(-k // splits)
    per = -(-per // 32) * 32
    return per, -(-k // per)


def _launch(x2, w_q, scale, out, partial, per, splits, way, tiling):
    """One launch of B8's C entry point on route `way`, on x's device;
    raises on a CUDA error."""
    m, k = x2.shape
    rc = _build.launch(
        "quantized_matmul", "pt_weight_only_matmul", x2.device,
        x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
        0 if partial is None else partial.data_ptr(), m, k, w_q.shape[1],
        per, splits, _DTYPES[x2.dtype], _ROUTES[way], *tiling)
    if rc != 0:
        raise RuntimeError(f"weight_only_matmul kernel launch failed "
                           f"({way} route): CUDA error {rc}")


def _tile_timer(x2, w_q, scale, out):
    """The tuner's `measure` for the "tma" route on these tensors: the
    device seconds of one launch at a candidate tile (`kernels/timing.py`'s
    method, L2 flushed before each call). Launches made to measure count
    none."""
    cold = []

    def measure(blocks):
        from paddle_tpu_torch.kernels import timing

        if not cold:
            cold.append(timing.ColdL2(x2.device))
        tiling = (blocks["tile_m"], blocks["tile_n"])
        return timing.cold_ms(lambda: _launch(
            x2, w_q, scale, out, None, x2.shape[1], 1, "tma", tiling),
            cold[0]) / 1e3
    return measure


def weight_only_matmul(x, w_q, scale, out_dtype=None):
    """B8: x [..., K] @ (w_q [K, N] int8 * scale [N] / 127) -> [..., N] in
    out_dtype (default x's dtype)."""
    if w_q.dim() != 2 or x.shape[-1] != w_q.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} does not fit weight "
                         f"{tuple(w_q.shape)} (want [..., K] @ [K, N])")
    k, n = w_q.shape
    if scale.shape != (n,):
        raise ValueError(f"scale {tuple(scale.shape)} is not [{n}]")
    if w_q.dtype != torch.int8:
        raise TypeError(f"weight must be int8 codes, got {w_q.dtype}")
    devices = {t.device for t in (x, w_q, scale)}
    if len(devices) != 1:
        raise ValueError("tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return dequant_matmul_plain(x, w_q, scale, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"kernel takes bfloat16 or float32 x, got {x.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    for t in (x, w_q, scale):
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m and n:
        partial, per, splits, tiling = None, k, 1, (0, 0)
        way = route(m, k, n, x.dtype, x2.data_ptr(), w_q.data_ptr())
        if way == "gemv" and x.dtype == torch.bfloat16:
            per, splits = gemv_split(k, n, _sms(dev))
        elif way == "gemv":
            per, splits = _k_split(k, n, dev)
            if splits > 1:
                partial = torch.empty((splits, m, n), dtype=torch.float32,
                                      device=dev)
        elif way == "tma":
            tiling = tuned_tile(m, k, n, x.dtype, dev,
                                measure=_tile_timer(x2, w_q, scale, out))
        _launch(x2, w_q, scale, out, partial, per, splits, way, tiling)
        launches["weight_only_matmul"] += 1
        if way == "tma":
            launches["weight_only_matmul_prefill"] += 1
        elif way == "mma":
            launches["weight_only_matmul_offgate"] += 1
    out = out.reshape(*lead, n)
    return out.to(out_dtype) if out_dtype is not None else out


# ---------------------------------------------------------------------------
# one custom operator: a node of an exported program, launched at its call
# ---------------------------------------------------------------------------


@torch.library.custom_op("paddle_tpu_torch::weight_only_matmul",
                         mutates_args=())
def weight_only_matmul_op(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """`weight_only_matmul` as one operator: B8 on a CUDA tensor,
    `dequant_matmul_plain` on a CPU one, chosen at call time; out in x's
    dtype."""
    return weight_only_matmul(x.contiguous(), w_q, scale)


@weight_only_matmul_op.register_fake
def _(x, w_q, scale):
    return x.new_empty((*x.shape[:-1], w_q.shape[1]))


def _setup(ctx, inputs, output):
    x, w_q, scale = inputs
    ctx.save_for_backward(x, w_q, scale)


def _backward(ctx, g):
    x, w_q, scale = ctx.saved_tensors
    dx = ds = None
    if ctx.needs_input_grad[0]:
        dx = g @ (w_q.to(g.dtype) * (scale.to(g.dtype) / 127.0)).T
    if ctx.needs_input_grad[2]:
        k, n = w_q.shape
        xw = x.reshape(-1, k).float() @ w_q.float()
        ds = (g.reshape(-1, n).float() * xw).sum(0) / 127.0
    return dx, None, ds


weight_only_matmul_op.register_autograd(_backward, setup_context=_setup)

# the operator's overload, as an exported graph names it
WEIGHT_ONLY_MATMUL_OP = torch.ops.paddle_tpu_torch.weight_only_matmul.default
