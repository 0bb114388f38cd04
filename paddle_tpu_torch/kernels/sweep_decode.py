"""Where the decode-time kernels B5 (window attention, bf16) and B8's GEMV
(M <= 16, bf16 x) spend their time, on one NVIDIA card.

    python3 -m paddle_tpu_torch.kernels.sweep_decode

1. Each kernel through its C entry point at the serving shapes, with the
   number of blocks over the keys (B5) or over K (B8: the cluster) set by
   hand beside the one the wrapper's rule picks (`window_splits`,
   `gemv_split`), each checked against the plain version run in f32 (the
   per-row bar of `chip_smoke.py`), beside the library call: SDPA over the
   keys the kernel reads (B5), `torch.matmul` over the dequantized weight
   (B8).
2. Copies of the two kernels with a part taken out, built from edited
   copies of `csrc/attention.cu` and `csrc/quantized_matmul.cu` into
   `build/paddle_tpu_torch/sweep_decode/`:
     B5: without the products and the online softmax; without the
         combine of the splits (and its distributed shared-memory reads);
         without both (the cp.async ring and the barriers alone); a
         ring of 4 stages at head_dim 128 instead of 3;
     B8: without the widening of the codes; without the products; the
         loads alone (every code word folded into one sum, no widening,
         gathers or products); without the cluster combine (each block
         writes its own sums); with 2 and with 4 k16 steps of loads in
         flight a thread instead of 3 (up to 8 rows of x); the code loads
         through __ldg, which the compiler may move, instead of volatile
         asm.
   Their outputs are wrong by construction; only their times are read.

Times are CUDA-event medians of 20 calls, the L2 cache flushed before each
and the card held busy (`torch.cuda._sleep`) while the host enqueues the
call, so that no host time is counted. Needs a card and nvcc; prints the
card's name and power limit first.
"""

from __future__ import annotations

import ctypes
import math
import statistics
import subprocess

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import attention as at
from paddle_tpu_torch.kernels import quantized_matmul as qm

# (b, s, nh, nkv, hd, cache length, pos): the paged-prefill suffix and the
# speculative verify window at Llama-2-7B width
B5_SHAPES = ((1, 16, 32, 32, 128, 2064, [512]),
             (8, 5, 32, 32, 128, 1100, [1000, 3, 64, 59, 0, 500, 127, 777]))
# (M, K, N): the decode step's four shapes at 8 rows, and 1 and 16 rows
B8_SHAPES = tuple((m, k, n) for m in (8, 1, 16)
                  for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                               (4096, 32000)))

# (text, replacement, times found) edits of a copy of a source
B5_PRODUCTS = [("    if (active) {\n      const int mat = lane / 8;",
                "    if (false) {\n      const int mat = lane / 8;", 1)]
B5_COMBINE = [("  for (int r = z + nsplit * warp; r < rows; "
               "r += nsplit * 4) {",
               "  for (int r = rows; r < rows; ++r) {", 1),
              ("  cluster_sync();", "  __syncthreads();", 2)]
B5_STAGES = [("  static constexpr int kStages = HD == 128 ? 3 : 4;",
              "  static constexpr int kStages = 4;", 1)]
B5_VARIANTS = {"without the products and softmax": B5_PRODUCTS,
               "without the combine": B5_COMBINE,
               "the ring and barriers alone": B5_PRODUCTS + B5_COMBINE,
               "a ring of 4 stages": B5_STAGES}
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

_SLEEP_CYCLES = 400_000   # ~0.2 ms at the H100's clock: the host's enqueue


def _ms(fn, flush, iters=20):
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(_SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    return statistics.median(times)


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
            fn = next((k for k in ("window_mma_kernel", "b8_gemv_mma_kernel")
                       if k in line), None)
            if fn:
                fn += line.split(fn)[1][:8]
        elif fn and ("registers" in line or "spill" in line):
            print(f"  [{what}] {fn}: {line.split(':')[-1].strip()}",
                  flush=True)


def _b5_call(lib, q, ck, cv, pos, out, splits):
    b, s, nh, hd = q.shape
    nkv, length = ck.shape[1], ck.shape[2]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.pt_window_attention(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, s, nh, nkv, length, hd, 1, splits,
            1.0 / math.sqrt(hd), stream)
        if rc != 0:
            raise RuntimeError(f"B5 launch failed: CUDA error {rc}")
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


def main():
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    for name in ("attention", "quantized_matmul"):
        _print_resources(name, _build.build(name)[1])
    attn, qmm = _build.lib("attention"), _build.lib("quantized_matmul")
    b5_libs = _variant_libs("attention", B5_VARIANTS)
    b8_libs = _variant_libs("quantized_matmul", B8_VARIANTS)

    for shape in B5_SHAPES:
        b, s, nh, nkv, hd, length, pos = shape
        q, ck, cv, p = _b5_case(dev, *shape)
        ref = at.window_attention_plain(q.float(), ck.float(), cv.float(), p)
        out = torch.empty_like(q)
        rule = at.window_splits(b, nkv, length - 1, sms)
        print(f"B5 b={b} s={s} nh={nh} nkv={nkv} len={length} pos={pos}: "
              f"the rule picks {rule} split(s); SDPA over the keys read "
              f"{_ms(_b5_sdpa(q, ck, cv, p), flush):.4f} ms", flush=True)
        for splits in sorted({1, 2, 4, 8, rule}):
            call = _b5_call(attn, q, ck, cv, p, out, splits)
            call()
            torch.cuda.synchronize()
            ratio = _row_ratio(out, ref)
            if not ratio <= 1.0:
                raise AssertionError(f"B5 {splits} splits: row ratio {ratio}")
            print(f"  {splits} split(s): {_ms(call, flush):.4f} ms, worst row "
                  f"at {ratio:.3f} of its bar", flush=True)
        for label, lib in b5_libs.items():
            print(f"  {label} ({rule} splits): "
                  f"{_ms(_b5_call(lib, q, ck, cv, p, out, rule), flush):.4f}"
                  " ms", flush=True)

    for m, k, n in B8_SHAPES:
        x, w, s = _b8_case(dev, m, k, n)
        ref = qm.dequant_matmul_plain(x.float(), w, s)
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        rule = qm.gemv_split(m, k, n, sms)
        wd = w.to(torch.bfloat16) * (s.to(torch.bfloat16) / 127.0)
        print(f"B8 M={m} K={k} N={n}: the rule picks (K rows a block, "
              f"cluster) {rule}; torch.matmul "
              f"{_ms(lambda: torch.matmul(x, wd), flush):.4f} ms", flush=True)
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
                  f"{_ms(call, flush):.4f} ms, worst row at {ratio:.3f} of "
                  "its bar", flush=True)
        if m == 8:
            for label, lib in b8_libs.items():
                t = _ms(_b8_call(lib, x, w, s, out, *rule), flush)
                print(f"  {label} (cluster {rule[1]}): {t:.4f} ms",
                      flush=True)


if __name__ == "__main__":
    main()
