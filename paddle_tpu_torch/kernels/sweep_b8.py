"""Where kernel B8's TMA + wgmma route spends its time, on one NVIDIA card.

    python3 -m paddle_tpu_torch.kernels.sweep_b8

1. Every output tile of `quantized_matmul.TILES` at the serving path's
   prefill shapes, through the C entry point, each checked against the
   plain version (bf16 bar, 2^-6 of max |plain|), beside the tile
   `quantized_matmul.tile` picks and `torch.matmul` over the dequantized
   weight. These times set the factors of `TILES`.
2. At M=2048, K=4096, N=11008 and the picked tile, copies of the kernel
   with a part taken out, built from edited copies of
   `csrc/quantized_matmul.cu` into `build/paddle_tpu_torch/sweep_b8/`:
   without the widening of the codes, without the wgmma products, and
   with both gone (the TMA copies and the barriers alone). Their outputs
   are wrong by construction; only their times are read.

Times are CUDA-event medians of 20 calls, the L2 cache flushed before
each. Needs a card and nvcc; prints the card's name and power limit
first.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import quantized_matmul as qm

SHAPES = ((2048, 4096, 11008), (2048, 11008, 4096), (512, 4096, 4096),
          (512, 4096, 11008), (1500, 4096, 4096), (1500, 4096, 11008))
# the loops a variant empties: the widening and the products of a stage
WIDEN = "for (int i = 0; i < kChunks / 128; ++i) {"
PRODUCTS = "for (int kk = 0; kk < kTBK / 16; ++kk) {"
VARIANTS = {"without the widening": (WIDEN,),
            "without the products": (PRODUCTS,),
            "TMA loads and barriers alone": (WIDEN, PRODUCTS)}


def _ms(fn, flush, iters=20):
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        e.record()
        e.synchronize()
        times.append(a.elapsed_time(e))
    return statistics.median(times)


def _caller(lib, x, w, s, out, rows, cols):
    m, k = x.shape
    n = w.shape[1]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.pt_weight_only_matmul(
            x.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(), 0, m,
            k, n, k, 1, 1, qm._ROUTES["tma"], rows, cols, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return call


def _variant_libs():
    """{name: loaded library} of the kernel with loops emptied."""
    src = _build.SOURCES["quantized_matmul"]
    out_dir = _build.BUILD_DIR / "sweep_b8"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, loops in VARIANTS.items():
        text = src.read_text()
        for loop in loops:
            if text.count(loop) != 1:
                raise RuntimeError(f"loop not found once: {loop}")
            text = text.replace(loop, loop.replace("; ++", " && false; ++"))
        cu = out_dir / f"{name.replace(' ', '_')}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(src.parent), "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        fn = lib.pt_weight_only_matmul
        fn.argtypes = _build._SIGNATURES["quantized_matmul"][
            "pt_weight_only_matmul"]
        fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main():
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    lib = _build.lib("quantized_matmul")
    for m, k, n in SHAPES:
        x, w, s = _case(dev, m, k, n)
        ref = qm.dequant_matmul_plain(x, w, s).float()
        bar = 2.0**-6 * max(1.0, ref.abs().max().item())
        out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        print(f"M={m} K={k} N={n}: the rule picks {qm.tile(m, n, sms)}",
              flush=True)
        for rows, cols in qm.TILES:
            call = _caller(lib, x, w, s, out, rows, cols)
            call()
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if err > bar:
                raise AssertionError(f"tile {rows}x{cols}: {err} > {bar}")
            print(f"  tile {rows}x{cols}: {_ms(call, flush):.4f} ms, "
                  f"error at {err / bar:.3f} of the bar", flush=True)
        wd = w.to(torch.bfloat16) * (s.to(torch.bfloat16) / 127.0)
        print(f"  torch.matmul {_ms(lambda: torch.matmul(x, wd), flush):.4f}"
              " ms", flush=True)
    m, k, n = SHAPES[0]
    x, w, s = _case(dev, m, k, n)
    out = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    rows, cols = qm.tile(m, n, sms)
    print(f"M={m} K={k} N={n}, tile {rows}x{cols}: the kernel "
          f"{_ms(_caller(lib, x, w, s, out, rows, cols), flush):.4f} ms",
          flush=True)
    for name, vlib in _variant_libs().items():
        t = _ms(_caller(vlib, x, w, s, out, rows, cols), flush)
        print(f"  {name}: {t:.4f} ms", flush=True)


def _case(dev, m, k, n, seed=4):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w, s = qm.quantize_absmax(torch.randn(k, n, generator=g, device=dev)
                              * 0.02)
    return x, w, s


if __name__ == "__main__":
    main()
