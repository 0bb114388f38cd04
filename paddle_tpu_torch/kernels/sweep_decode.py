"""Where the decode-time kernels B4 (decode over the contiguous cache,
bf16), B5 (window attention, bf16), B6 and B7 (paged decode over a bf16 or
an int8 pool, bf16 q) and B8's GEMV (M <= 16, bf16 x) spend their time, on
one NVIDIA card.

    python3 -m paddle_tpu_torch.kernels.sweep_decode

1. Each kernel through its C entry point at the serving shapes, with the
   number of blocks over the keys (B4-B7: every row cut over min(that
   count, its tiles), split_tiles 1) or over K (B8: the cluster) set by
   hand beside the one the wrapper's rule picks (`decode_splits`,
   `window_splits`, `paged_splits` with and without the engine's bound
   on pos, `gemv_split`); then B4-B7 under the per-row rule at several
   thresholds (`row_splits`' tiles a split, the cluster cut for the
   longest row as the wrappers cut it), the data that sets
   WINDOW_SPLIT_TILES and PAGED_SPLIT_TILES; each checked against the
   plain version run in
   f32 (the per-row bar of `chip_smoke.py`), beside the library call: SDPA
   over the keys the kernel reads (B4-B7; B7 over the dequantized keys),
   `torch.matmul` over the dequantized weight (B8). B4, B6 and B7 also run
   the shared CUDA-core body in bf16 (`splits` 0), the kernel they
   replaced, in the same call. B4 also runs its keys through the paged
   entry point as a pool of one page a row (a table [[0], [1], ...], pages
   of len keys): decode_mma_kernel with a contiguous cp.async source in
   place of its TMA source; and, at the timing shape, B6 over a pool of
   pages of 16 holding the same keys.
2. Copies of the kernels with a part taken out, built from edited copies
   of `csrc/attention.cu` and `csrc/quantized_matmul.cu` into
   `build/paddle_tpu_torch/sweep_decode/`:
     B5: without the products and the online softmax; without the
         combine of the splits (and its distributed shared-memory reads);
         without both (the cp.async ring and the barriers alone); a
         ring of 4 stages at head_dim 128 instead of 3;
     B4, B6, B7 (one kernel, decode_mma_kernel): the same three (the
         loads alone: B4's TMA ring and barriers; B6/B7's block-table
         reads, cp.async ring and barriers); B7 without its scales (neither
         their copies nor the multiplies); all 16 rows of the row tile
         kept at g <= 8 (the kernel keeps rows 0-7); B7 at g <= 8 capped
         at 128 registers a thread (4 blocks an SM); rings of 2, 3 and 4
         stages (bf16: 2, int8: 3, at head_dim 128; B4 and B6 alike);
     B8: without the widening of the codes; without the products; the
         loads alone (every code word folded into one sum, no widening,
         gathers or products); without the cluster combine (each block
         writes its own sums); with 2 and with 4 k16 steps of loads in
         flight a thread instead of 3 (up to 8 rows of x); the code loads
         through __ldg, which the compiler may move, instead of volatile
         asm.
   Their outputs are wrong by construction; only their times are read.

`--rule-only` skips part 2 (no variant is built): the split counts and
the per-row rule's thresholds alone.

Times are CUDA-event medians of 20 calls under the kernel table's method
(`timing.METHOD`: the L2 cache flushed before each call, the card held
busy while the host enqueues it, so that no host time is counted). Needs
a card and nvcc; prints the card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import math
import subprocess

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import attention as at
from paddle_tpu_torch.kernels import quantized_matmul as qm
from paddle_tpu_torch.kernels import timing

# (label, b, nh, nkv, hd, cache length, pos): B4 at the timing shape (8
# rows ragged to 2047 at Llama-2-7B width) and at the speculative draft's
# stripe (h2048: 16 kv heads; max_len + spec_tokens + 1 = 1029 keys)
B4_SHAPES = (("ragged to 2047", 8, 32, 32, 128, 2048,
              (2047, 1500, 777, 513, 64, 17, 1, 0)),
             ("the draft's stripe", 8, 16, 16, 128, 1029,
              (1028, 700, 64, 63, 0, 1, 500, 900)))
# (b, s, nh, nkv, hd, cache length, pos): the paged-prefill suffix and the
# speculative verify window at Llama-2-7B width
B5_SHAPES = ((1, 16, 32, 32, 128, 2064, [512]),
             (8, 5, 32, 32, 128, 1100, [1000, 3, 64, 59, 0, 500, 127, 777]),
             (1, 16, 32, 32, 128, 2064, [1024]),
             (1, 16, 32, 32, 128, 2064, [2000]),
             (1, 16, 32, 32, 128, 2064, [192]))
# tiles a split tried for the per-row rule (`attention.row_splits`)
SPLIT_TILES = (2, 4, 6, 8, 12, 16, 24, 32)
# (label, pos): B6/B7 at Llama-2-7B width, a row a pos, pages of 16, tables
# of 128 pages: the timing phase's ragged rows, one row alone (a request
# decoding by itself: `generate` at b=1, the logits check), and the engine's
# decode shape (chip_smoke.phase_profile: 8 rows at 256-320 keys)
PAGED_SHAPES = (("ragged to 2047", (2047, 1500, 777, 513, 64, 17, 1, 0)),
                ("one row of 600 keys", (599,)),
                ("one row of 1000 keys", (999,)),
                ("the engine's decode, 256-319 keys",
                 tuple(256 + 9 * i for i in range(8))))
# (M, K, N): the decode step's four shapes at 8 rows, and 1 and 16 rows
B8_SHAPES = tuple((m, k, n) for m in (8, 1, 16)
                  for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                               (4096, 32000)))

# (text, replacement, times found) edits of a copy of a source
B5_PRODUCTS = [("    if (active) {\n      const int mat = lane / 8;",
                "    if (false) {\n      const int mat = lane / 8;", 1)]
B5_COMBINE = [("  for (int r = z + nsplit * warp; r < rows; "
               "r += nsplit * 4) {",
               "  for (int r = rows; r < rows; ++r) {", 2),
              ("  cluster_sync();", "  __syncthreads();", 4)]
B5_STAGES = [("  static constexpr int kStages = HD == 128 ? 3 : 4;",
              "  static constexpr int kStages = 4;", 1)]
B5_VARIANTS = {"without the products and softmax": B5_PRODUCTS,
               "without the combine": B5_COMBINE,
               "the ring and barriers alone": B5_PRODUCTS + B5_COMBINE,
               "a ring of 4 stages": B5_STAGES}
PAGED_PRODUCTS = [("    if (active) {\n      const uint8_t* kt = ring",
                   "    if (false) {\n      const uint8_t* kt = ring", 1)]
PAGED_SCALES = [("        if (cq == 0) {", "        if (false) {", 1),
                ("          const float f = kQ8 ? sl2 * ksc[t] : sl2;",
                 "          const float f = sl2;", 1),
                ("        if constexpr (kQ8) {\n          v0 = vsc[t] / 127.f;",
                 "        if constexpr (false) {\n          v0 = vsc[t] / 127.f;",
                 1)]
PAGED_STAGES = {n: [("  static constexpr int kStages = HD == 128 ? (kQ8 ? 3 : 2) "
                     ": 4;", f"  static constexpr int kStages = {n};", 1)]
                for n in (2, 3, 4)}
PAGED_FULL_TILE = [("  if (g <= 8)\n    return launch_decode_mma<Keys, HD, 4, true>",
                    "  if (false)\n    return launch_decode_mma<Keys, HD, 4, true>",
                    1)]
PAGED_CAP = [("__global__ void __launch_bounds__(kWinThreads) "
               "decode_mma_kernel(",
               "__global__ void __launch_bounds__(kWinThreads, kTop && "
               "sizeof(typename Keys::KVT) == 1 ? 4 : 1) decode_mma_kernel(",
               1)]
PAGED_VARIANTS = {"without the products and softmax": PAGED_PRODUCTS,
                  "without the combine": B5_COMBINE,
                  "the loads alone": PAGED_PRODUCTS + B5_COMBINE,
                  "B7 without its scales": PAGED_SCALES,
                  "all 16 rows of the tile kept (g <= 8)": PAGED_FULL_TILE,
                  "B7 at g <= 8 capped at 128 registers (4 blocks an SM)":
                      PAGED_CAP,
                  **{f"a ring of {n} stages": e
                     for n, e in PAGED_STAGES.items()}}
B8_WIDEN = [("      const uint32_t a[4] = {widen2_bf16(g01, 0), "
             "widen2_bf16(g01, 2),\n"
             "                             widen2_bf16(g23, 0), "
             "widen2_bf16(g23, 2)};",
             "      const uint32_t a[4] = {g01, g23, g01 ^ 1u, g23 ^ 1u};", 1)]
B8_PRODUCTS = [("        mma_16816(acc[t][mt], a, xr[mt].x, xr[mt].y);",
                "        acc[t][mt][0] += __uint_as_float("
                "a[0] ^ a[1] ^ a[2] ^ a[3] ^ xr[mt].x ^ xr[mt].y);", 1)]
B8_COMBINE = [("    for (int r = 0; r < ranks; ++r) sum += "
               "ld_cluster(map_rank(a, r));",
               "    sum = red[col * R8 + m];", 1),
              ("  cluster_sync();", "  __syncthreads();", 2)]
B8_DEPTH = {d: [("  static constexpr int kDepth = MT == 1 ? 3 : 2;",
                 f"  static constexpr int kDepth = MT == 1 ? {d} : 2;", 1)]
            for d in (2, 4)}
_WORDS = " ^ ".join(f"c[d][{kk}].{f}" for kk in range(4) for f in "xyzw")
B8_LOADS = [("        compute(c[d], xr[d]);",
             "        acc[0][0][0] += __uint_as_float(0x3f800000u | ((" +
             _WORDS + " ^ xr[d][0].x ^ xr[d][0].y) & 0x7fffffu));", 1)]
B8_LDG = [("          u = ld_stream16(row);",
           "          u = __ldg(reinterpret_cast<const uint4*>(row));", 1)]
B8_VARIANTS = {"without the widening": B8_WIDEN,
               "without the products": B8_PRODUCTS,
               "the loads alone": B8_LOADS,
               "without the cluster combine": B8_COMBINE,
               "a ring of 2 steps": B8_DEPTH[2],
               "a ring of 4 steps": B8_DEPTH[4],
               "the code loads through __ldg": B8_LDG}

def _ms(fn, l2, iters=20):
    return timing.cold_ms(fn, l2, iters=iters)


def _row_ratio(got, ref, tol=2.0**-6):
    d = (got.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    bar = (tol * top).clamp_min(1e-5 * top.max().item())
    return (d / bar.clamp_min(1e-30)).max().item()


def _variant_libs(name, variants):
    """{variant: loaded library} of source `name` with the edits made."""
    src = _build.SOURCES[name]
    out_dir = _build.BUILD_DIR / "sweep_decode"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, edits in variants.items():
        text = src.read_text()
        for old, new, times in edits:
            if text.count(old) != times:
                raise RuntimeError(f"{name}: not found {times} times: {old}")
            text = text.replace(old, new)
        stem = "".join(c if c.isalnum() else "_" for c in label)
        cu = out_dir / f"{name}_{stem}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[label] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(src.parent), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            first = next((ln for ln in err.splitlines() if "error" in ln),
                         err)
            print(f"  [{name}, {label}] nvcc failed, variant skipped: "
                  f"{first}", flush=True)
            continue
        _print_resources(f"{name}, {label}", err)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _build._SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def _print_resources(what, report):
    """The registers and spills ptxas reports for the two kernels."""
    fn = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = next((k for k in ("window_mma_kernel", "decode_mma_kernel",
                                   "b8_gemv_mma_kernel")
                       if k in line), None)
            if fn:
                fn += line.split(fn)[1].split("EEEv")[0]
        elif fn and ("registers" in line or "spill" in line):
            print(f"  [{what}] {fn}: {line.split(':')[-1].strip()}",
                  flush=True)


def _b5_call(lib, q, ck, cv, pos, out, splits, split_tiles=1):
    """B5 through its C entry point: a cluster of `splits` blocks, each row
    cut over its own `row_splits` of them (split_tiles 1: min(splits, the
    row's tiles))."""
    b, s, nh, hd = q.shape
    nkv, length = ck.shape[1], ck.shape[2]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.pt_window_attention(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, s, nh, nkv, length, hd, 1, split_tiles,
            splits, 1.0 / math.sqrt(hd), stream)
        if rc != 0:
            raise RuntimeError(f"B5 launch failed: CUDA error {rc}")
    return call


def _b4_call(lib, q, ck, cv, pos, out, splits, split_tiles=1):
    """B4 through its C entry point: `splits` blocks a cluster (the TMA
    source), each row cut over its own `row_splits` of them, or 0 for the
    shared body."""
    b, _, nh, hd = q.shape
    nkv, length = ck.shape[1], ck.shape[2]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.pt_decode_attention(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, nh, nkv, length, hd, 1, split_tiles, splits,
            1.0 / math.sqrt(hd), stream)
        if rc != 0:
            raise RuntimeError(f"B4 launch failed: CUDA error {rc}")
    return call


def _paged_call(lib, q, pool_k, pool_v, bt, pos, out, splits, scales=None,
                split_tiles=1):
    """B6 (B7 with `scales` = (k_scale, v_scale)) through its C entry point:
    `splits` blocks a cluster, each row cut over its own `row_splits` of
    them, or 0 for the shared body."""
    b, _, nh, hd = q.shape
    nkv, ps = pool_k.shape[1], pool_k.shape[2]
    P = bt.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr()) + (
        (scales[0].data_ptr(), scales[1].data_ptr()) if scales else ())
    fn = (lib.pt_paged_decode_attention_q8 if scales
          else lib.pt_paged_decode_attention)

    def call():
        rc = fn(*ptrs, bt.data_ptr(), pos.data_ptr(), out.data_ptr(), b, nh,
                nkv, ps, P, hd, 1, split_tiles, splits, 1.0 / math.sqrt(hd),
                stream)
        if rc != 0:
            raise RuntimeError(f"B6/B7 launch failed: CUDA error {rc}")
    return call


def _b8_call(lib, x, w, s, out, per, ranks):
    m, k = x.shape
    n = w.shape[1]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.pt_weight_only_matmul(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), 0, m,
            k, n, per, ranks, 1, qm._ROUTES["gemv"], 0, 0, stream)
        if rc != 0:
            raise RuntimeError(f"B8 launch failed: CUDA error {rc}")
    return call


def _b5_case(dev, b, s, nh, nkv, hd, length, pos):
    g = torch.Generator(device=dev).manual_seed(1)
    ck = torch.randn(b, nkv, length, hd, device=dev, generator=g).bfloat16()
    cv = torch.randn(b, nkv, length, hd, device=dev, generator=g).bfloat16()
    q = torch.randn(b, s, nh, hd, device=dev, generator=g).bfloat16()
    return q, ck, cv, torch.tensor(pos, dtype=torch.int32, device=dev)


def _paged_case(dev, pos, q8, b=8, nh=32, nkv=32, hd=128, ps=16, P=128):
    """(q, pool_k, pool_v, bt, pos) over b rows of P shuffled pages (page 0
    the null page), and (k_scale, v_scale) or None: an int8 pool of codes
    in [-127, 127] with scales in [0.5, 2.5], the last row's first page at
    scale 0 (a fresh page)."""
    g = torch.Generator(device=dev).manual_seed(2)
    n_pages = 1 + b * P
    shape = (n_pages, nkv, ps, hd)
    bt = (torch.randperm(n_pages - 1, device=dev, generator=g) + 1) \
        .reshape(b, P).to(torch.int32).contiguous()
    q = torch.randn(b, 1, nh, hd, device=dev, generator=g).bfloat16()
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    if not q8:
        pk = torch.randn(shape, device=dev, generator=g).bfloat16()
        pv = torch.randn(shape, device=dev, generator=g).bfloat16()
        return (q, pk, pv, bt, pos_t), None
    codes = [torch.randint(-127, 128, shape, generator=g, device=dev,
                           dtype=torch.int8) for _ in range(2)]
    scales = [torch.rand(n_pages, nkv, generator=g, device=dev) * 2 + 0.5
              for _ in range(2)]
    for sc in scales:
        sc[bt[min(1, b - 1), 0]] = 0.0
    return (q, *codes, bt, pos_t), tuple(scales)


def _b8_case(dev, m, k, n):
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    w, s = qm.quantize_absmax(torch.randn(k, n, generator=g, device=dev)
                              * 0.02)
    return x, w, s


def _b5_sdpa(q, ck, cv, pos):
    s = q.shape[1]
    last = min(int(pos.max()) + s - 1, ck.shape[2] - 1)
    qpos = pos[:, None, None, None].long() + torch.arange(
        s, device=q.device)[None, None, :, None]
    mask = torch.arange(last + 1, device=q.device) <= qpos
    qt, kr, vr = q.transpose(1, 2), ck[:, :, :last + 1], cv[:, :, :last + 1]
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kr, vr, attn_mask=mask)


def _b4_case(dev, b, nh, nkv, hd, length, pos):
    g = torch.Generator(device=dev).manual_seed(5)
    ck = torch.randn(b, nkv, length, hd, device=dev, generator=g).bfloat16()
    cv = torch.randn(b, nkv, length, hd, device=dev, generator=g).bfloat16()
    q = torch.randn(b, 1, nh, hd, device=dev, generator=g).bfloat16()
    return q, ck, cv, torch.tensor(pos, dtype=torch.int32, device=dev)


def _b4_shape(dev, l2, attn, libs, label, b, nh, nkv, hd, length, pos):
    """B4 at one B4_SHAPES row: the shared body, every split count, the
    rule, the library call; the same keys through the contiguous cp.async
    source and (len 2048) through B6 over pages of 16; then the variants
    at the rule's split count."""
    q, ck, cv, p = _b4_case(dev, b, nh, nkv, hd, length, pos)
    ref = at.decode_attention_plain(q.float(), ck.float(), cv.float(), p)
    out = torch.empty_like(q)
    rule = at.decode_splits(length - 1)
    mask = (torch.arange(length, device=dev)[None, :]
            <= p[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    lib_ms = _ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, ck, cv, attn_mask=mask), l2)
    print(f"B4 b={b} nh={nh} nkv={nkv} len={length} {label}: the rule picks "
          f"{rule} split(s); SDPA over the keys {lib_ms:.4f} ms", flush=True)

    def timed(what, call):
        call()
        torch.cuda.synchronize()
        ratio = _row_ratio(out, ref)
        if not ratio <= 1.0:
            raise AssertionError(f"B4 {what}: row ratio {ratio}")
        print(f"  {what}: {_ms(call, l2):.4f} ms, worst row at {ratio:.3f} of "
              f"its bar", flush=True)

    for splits in (0, 1, 2, 4, 8):
        timed("the shared body" if splits == 0 else f"{splits} split(s)",
              _b4_call(attn, q, ck, cv, p, out, splits))
    for tiles in SPLIT_TILES:
        cluster = at.row_splits(length - 1, tiles)
        timed(f"the per-row rule at {tiles} tiles a split (cluster "
              f"{cluster})", _b4_call(attn, q, ck, cv, p, out, cluster,
                                      tiles))
    # the cache as a pool of b pages of len keys, page r row r's
    table = torch.arange(b, dtype=torch.int32, device=dev)[:, None]
    timed(f"the contiguous cp.async source (the paged entry point, one page "
          f"a row), {rule} split(s)",
          _paged_call(attn, q, ck, cv, table, p, out, rule,
                      split_tiles=at.PAGED_SPLIT_TILES))
    if length % 16 == 0:
        # B6 over pages of 16 holding the same keys, in table order
        def pages(c):
            return c.reshape(b, nkv, length // 16, 16, hd).transpose(
                1, 2).reshape(-1, nkv, 16, hd).contiguous()

        bt = torch.arange(b * length // 16, dtype=torch.int32,
                          device=dev).reshape(b, -1)
        split6 = at.paged_splits(length // 16, 16)
        timed(f"B6 over pages of 16 holding the same keys, {split6} "
              f"split(s)", _paged_call(attn, q, pages(ck), pages(cv), bt, p,
                                       out, split6,
                                       split_tiles=at.PAGED_SPLIT_TILES))
    for vlabel, lib in libs.items():
        if vlabel.startswith("B7"):
            continue
        t = _ms(_b4_call(lib, q, ck, cv, p, out, rule,
                         at.PAGED_SPLIT_TILES), l2)
        print(f"  {vlabel} ({rule} split(s)): {t:.4f} ms", flush=True)


def _paged_shape(dev, l2, attn, libs, label, pos):
    """B6 and B7 at one PAGED_SHAPES row: the shared body, every split
    count, the rule, the library call; then the variants at the split
    counts the rule picks with and without the bound on pos."""
    for q8 in (False, True):
        kid = "B7" if q8 else "B6"
        args, scales = _paged_case(dev, pos, q8, b=len(pos))
        bt = args[3]
        if q8:
            kw = {"k_scale": scales[0], "v_scale": scales[1]}
            ck = at.paged_gather(args[1], bt, scales[0], torch.bfloat16)
            cv = at.paged_gather(args[2], bt, scales[1], torch.bfloat16)
        else:
            kw = {}
            ck, cv = at.paged_gather(args[1], bt), at.paged_gather(args[2], bt)
        q, p = args[0], args[4]
        b, nkv, ps, P = q.shape[0], args[1].shape[1], args[1].shape[2], \
            bt.shape[1]
        ref = at.paged_decode_attention_plain(
            *[a.float() if a.is_floating_point() else a for a in args], **kw)
        mask = (torch.arange(ck.shape[2], device=dev)[None, :]
                <= p[:, None].long())[:, None, None, :]
        qt = q.transpose(1, 2)
        lib_ms = _ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, ck, cv, attn_mask=mask), l2)
        rule = at.paged_splits(P, ps)
        bound = at.paged_splits(P, ps, max(pos))
        print(f"{kid} b={b} ps={ps} P={P} {label}: the rule picks {rule} "
              f"split(s), {bound} with the bound max(pos) = {max(pos)}; "
              f"SDPA over the {'dequantized ' if q8 else ''}keys "
              f"{lib_ms:.4f} ms", flush=True)
        out = torch.empty_like(q)
        for splits in (0, 1, 2, 4, 8):
            call = _paged_call(attn, *args, out, splits, scales)
            call()
            torch.cuda.synchronize()
            ratio = _row_ratio(out, ref)
            if not ratio <= 1.0:
                raise AssertionError(f"{kid} {splits} splits: row ratio "
                                     f"{ratio}")
            what = "the shared body" if splits == 0 else f"{splits} split(s)"
            print(f"  {what}: {_ms(call, l2):.4f} ms, worst row at "
                  f"{ratio:.3f} of its bar", flush=True)
        for tiles in SPLIT_TILES:
            cluster = at.row_splits(max(pos), tiles)
            call = _paged_call(attn, *args, out, cluster, scales, tiles)
            call()
            torch.cuda.synchronize()
            ratio = _row_ratio(out, ref)
            if not ratio <= 1.0:
                raise AssertionError(f"{kid} {tiles} tiles a split: row "
                                     f"ratio {ratio}")
            print(f"  the per-row rule at {tiles} tiles a split (cluster "
                  f"{cluster}, the bound max(pos)): {_ms(call, l2):.4f} ms",
                  flush=True)
        for vlabel, lib in libs.items():
            if vlabel.startswith("B7") and not q8:
                continue
            for splits in sorted({rule, bound}):
                t = _ms(_paged_call(lib, *args, out, splits, scales,
                                    at.PAGED_SPLIT_TILES), l2)
                print(f"  {vlabel} ({splits} split(s)): {t:.4f} ms",
                      flush=True)
        del args, ck, cv


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rule-only", action="store_true",
                    help="no variants: split counts and thresholds only")
    rule_only = ap.parse_args(argv).rule_only
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    l2 = timing.ColdL2(dev)
    for name in ("attention", "quantized_matmul"):
        _print_resources(name, _build.build(name)[1])
    attn, qmm = _build.lib("attention"), _build.lib("quantized_matmul")
    b5_libs = {} if rule_only else _variant_libs("attention", B5_VARIANTS)
    paged_libs = ({} if rule_only
                  else _variant_libs("attention", PAGED_VARIANTS))
    b8_libs = ({} if rule_only
               else _variant_libs("quantized_matmul", B8_VARIANTS))

    for label, *shape in B4_SHAPES:
        _b4_shape(dev, l2, attn, paged_libs, label, *shape)

    for label, pos in PAGED_SHAPES:
        _paged_shape(dev, l2, attn, paged_libs, label, pos)

    for shape in B5_SHAPES:
        b, s, nh, nkv, hd, length, pos = shape
        q, ck, cv, p = _b5_case(dev, *shape)
        ref = at.window_attention_plain(q.float(), ck.float(), cv.float(), p)
        out = torch.empty_like(q)
        rule = at.window_splits(length - 1)
        print(f"B5 b={b} s={s} nh={nh} nkv={nkv} len={length} pos={pos}: "
              f"the rule picks {rule} split(s); SDPA over the keys read "
              f"{_ms(_b5_sdpa(q, ck, cv, p), l2):.4f} ms", flush=True)
        for splits in sorted({1, 2, 4, 8, rule}):
            call = _b5_call(attn, q, ck, cv, p, out, splits)
            call()
            torch.cuda.synchronize()
            ratio = _row_ratio(out, ref)
            if not ratio <= 1.0:
                raise AssertionError(f"B5 {splits} splits: row ratio {ratio}")
            print(f"  {splits} split(s): {_ms(call, l2):.4f} ms, worst row "
                  f"at {ratio:.3f} of its bar", flush=True)
        watermark = min(max(pos) + s - 1, length - 1)
        for tiles in SPLIT_TILES:
            cluster = at.row_splits(watermark, tiles)
            call = _b5_call(attn, q, ck, cv, p, out, cluster, tiles)
            call()
            torch.cuda.synchronize()
            ratio = _row_ratio(out, ref)
            if not ratio <= 1.0:
                raise AssertionError(f"B5 {tiles} tiles a split: row ratio "
                                     f"{ratio}")
            print(f"  the per-row rule at {tiles} tiles a split (cluster "
                  f"{cluster}): {_ms(call, l2):.4f} ms", flush=True)
        for label, lib in b5_libs.items():
            t = _ms(_b5_call(lib, q, ck, cv, p, out, rule,
                             at.WINDOW_SPLIT_TILES), l2)
            print(f"  {label} ({rule} splits): {t:.4f} ms", flush=True)

    for m, k, n in B8_SHAPES:
        x, w, s = _b8_case(dev, m, k, n)
        ref = qm.dequant_matmul_plain(x.float(), w, s)
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        rule = qm.gemv_split(k, n, sms)
        wd = w.to(torch.bfloat16) * (s.to(torch.bfloat16) / 127.0)
        print(f"B8 M={m} K={k} N={n}: the rule picks (K rows a block, "
              f"cluster) {rule}; torch.matmul "
              f"{_ms(lambda: torch.matmul(x, wd), l2):.4f} ms", flush=True)
        steps = -(-k // 16)
        tried = {rule}
        for ranks in (1, 2, 4, 8):
            if 8 * ranks <= steps:
                tried.add((128 * -(-steps // (8 * ranks)), ranks))
        for per, ranks in sorted(tried, key=lambda t: t[1]):
            call = _b8_call(qmm, x, w, s, out, per, ranks)
            call()
            torch.cuda.synchronize()
            ratio = _row_ratio(out, ref)
            if not ratio <= 1.0:
                raise AssertionError(f"B8 cluster {ranks}: row ratio {ratio}")
            print(f"  cluster {ranks} ({per} K rows a block): "
                  f"{_ms(call, l2):.4f} ms, worst row at {ratio:.3f} of "
                  "its bar", flush=True)
        if m == 8:
            for label, lib in b8_libs.items():
                t = _ms(_b8_call(lib, x, w, s, out, *rule), l2)
                print(f"  {label} (cluster {rule[1]}): {t:.4f} ms",
                      flush=True)


if __name__ == "__main__":
    main()
