"""Where B10 (RMSNorm backward, `rms_norm_bwd_kernel`) spends its time, on
one NVIDIA card.

    python3 -m paddle_tpu_torch.kernels.sweep_rms [--before FILE]

1. B10 through its wrapper at the training legs' micro-batches ([4096,
   4096] and [4096, 2048], bf16) and at [8, 4096], under each timing
   method of `timing.METHODS`, from a CUDA graph, beside F.rms_norm's
   backward (the library call, autograd of `torch.nn.functional.rms_norm`).
   With `--before FILE`, an earlier `rms_norm.cu` (B10's kernels before
   this design: a strip of rows a block, then a second kernel summing the
   dw partials) is built from FILE and timed the same way in the same
   process, through its own C signature.
2. B10 through its C entry point with the grid set by hand: (blocks,
   cluster) of `rms_norm.bwd_grid`, then at 4096 rows 128 blocks in
   clusters of 4, 132 blocks in clusters of 2 and of 1 (more partials,
   each summed by the last cluster alone), and half the SMs in clusters of
   2; at 8 rows 2 and 8 blocks in clusters of 1 and 2.
3. Copies of the kernel with a part taken out or changed, built from
   edited copies of `csrc/rms_norm.cu` into
   `build/paddle_tpu_torch/sweep_rms/`: an empty body (the launch of a
   cluster kernel with the ring's shared memory, alone); without the dw sum
   after the rows (the dx pass alone); the dw sum within each cluster only
   (no arrival count, no sum over the clusters); fence.acq_rel.gpu in
   place of __threadfence; without the dx stores (the loads and the row sums
   alone); a ring of one stage, and of three where they fit the ring's
   shared memory; 4 and 1 vectors a thread (row groups of 128 and 512
   threads at H 4096); and a probe of the dw sum's fixed cost: the
   cluster's first barrier without its release and acquire.
   Their outputs are wrong by construction; only their times are read.

Every kernel is checked against the plain version first (the bars of
`chip_smoke.py`: dx per row within 2^-6 of its largest entry, dw within
2^-7 of the largest). Times are CUDA-event medians of 20 calls under
`timing.METHOD` unless a line names its method. Needs a card and nvcc;
prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import rms_norm as rn
from paddle_tpu_torch.kernels import timing

EPS = 1e-6
SHAPES = ((4096, 4096), (4096, 2048), (8, 4096))
# (text, replacement, times found) edits of a copy of csrc/rms_norm.cu
NO_DW = [("  cp_async_wait<0>();\n  __syncthreads();", "  return;\n  "
          "__syncthreads();", 1)]
NO_DX = [("        store_vec(dxr + v * V, xf);",
          "        if (xf[0] == 1234.5f) store_vec(dxr + v * V, xf);", 1)]
_STAGES = "  const int S = G * 2 * (2 * H * itemsize) <= kRingBudget ? 2 : 1;"
ONE_STAGE = [(_STAGES, "  const int S = 1;", 1)]
THREE_STAGES = [
    (_STAGES, _STAGES.replace("G * 2", "G * 3").replace("? 2", "? 3"), 1),
    ("  if (p.S == 2) {", "  if (p.S == 3) {", 1)] + [
    (f"PT_BWD({nv}, 2);", f"PT_BWD({nv}, 3);", 1) for nv in (1, 2, 4, 8)]
_WANT = "  const int want = ((nvec + 1) / 2 + 31) / 32 * 32;"
VECTORS = {n: [(_WANT, _WANT.replace("+ 1) / 2", f"+ {n - 1}) / {n}"), 1)]
           for n in (4, 1)}
# a probe of the dw sum's fixed cost (wrong dw by construction): the
# cluster's first barrier without its release / acquire
RELAXED = [("  cluster_sync();\n  // block z of the cluster",
            '  asm volatile("barrier.cluster.arrive.relaxed.aligned;\\n"\n'
            '               "barrier.cluster.wait.aligned;\\n" ::: "memory");\n'
            "  // block z of the cluster", 1)]
EMPTY = [("  const int G = blockDim.x / R;\n",
          "  if (rows >= 0) return;\n  const int G = blockDim.x / R;\n", 1)]
NO_ARRIVAL = [("  __threadfence();    // this cluster's partial, before its "
               "arrival counts\n",
               "  cluster_sync();\n  return;\n", 1)]
_ACQ_REL = '  asm volatile("fence.acq_rel.gpu;\\n" ::: "memory");\n'
ACQ_REL = [("  __threadfence();    // this cluster's partial, before its "
            "arrival counts\n", _ACQ_REL, 1),
           ("  __threadfence();\n  for (int c = c0",
            _ACQ_REL + "  for (int c = c0", 1)]
VARIANTS = {"an empty body (the launch alone)": EMPTY,
            "the dx pass alone (no dw sum)": NO_DW,
            "the dw sum within each cluster only (no arrival, no final "
            "sum)": NO_ARRIVAL,
            "fence.acq_rel.gpu for __threadfence": ACQ_REL,
            "probe: the cluster's first barrier relaxed": RELAXED,
            "without the dx stores": NO_DX,
            "a ring of one stage": ONE_STAGE,
            "a ring of three stages (where they fit)": THREE_STAGES,
            **{f"{n} vector(s) a thread": e for n, e in VECTORS.items()}}
# the C signature of B10 before this design (x, w, r, g, dx, part, dw,
# rows, H, ldx, ldg, rows a strip, strips, dtype, stream)
_P, _I = ctypes.c_void_p, ctypes.c_int
BEFORE_SIGNATURE = [_P] * 7 + [_I] * 7 + [_P]


def _build_copy(src_text, stem, include):
    """nvcc a copy of a source (text) into build/paddle_tpu_torch/sweep_rms/;
    returns (library path, ptxas report) or (None, error)."""
    out_dir = _build.BUILD_DIR / "sweep_rms"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{stem}.cu"
    cu.write_text(src_text)
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-I", str(include),
                           "-o", str(so), str(cu)], capture_output=True,
                          text=True)
    if proc.returncode:
        return None, proc.stderr
    return so, proc.stderr


def _load(so, fn, argtypes):
    lib = ctypes.CDLL(str(so))
    getattr(lib, fn).argtypes = argtypes
    getattr(lib, fn).restype = ctypes.c_int
    return lib


def _variants():
    """{variant: loaded library} of csrc/rms_norm.cu with the edits made."""
    src = _build.SOURCES["rms_norm"]
    libs = {}
    for label, edits in VARIANTS.items():
        text = src.read_text()
        for old, new, times in edits:
            if text.count(old) != times:
                raise RuntimeError(f"rms_norm.cu: not found {times} times: "
                                   f"{old}")
            text = text.replace(old, new)
        stem = "".join(c if c.isalnum() else "_" for c in label)
        so, report = _build_copy(text, f"rms_norm_{stem}", src.parent)
        if so is None:
            print(f"  [{label}] nvcc failed, variant skipped: {report}",
                  flush=True)
            continue
        _print_resources(label, report)
        libs[label] = _load(so, "pt_rms_norm_bwd",
                            _build._SIGNATURES["rms_norm"]["pt_rms_norm_bwd"])
    return libs


def _print_resources(what, report):
    fn = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            fn = "rms_norm_bwd_kernel" if "rms_norm_bwd" in line else None
            if fn:
                fn += line.split("rms_norm_bwd_kernel")[1].split("EEEv")[0]
        elif fn and ("registers" in line or "spill" in line):
            print(f"  [{what}] {fn}: {line.split(':')[-1].strip()}",
                  flush=True)


def _call(lib, x, w, r, g, dx, dw, blocks, cluster):
    """B10 through the C entry point `lib` with the grid set by hand."""
    rows, h = x.shape
    counter, part = rn._bwd_scratch(x.device, blocks // cluster, h)

    def call():
        rc = lib.pt_rms_norm_bwd(
            x.data_ptr(), w.data_ptr(), r.data_ptr(), g.data_ptr(),
            dx.data_ptr(), dw.data_ptr(), part.data_ptr(),
            counter.data_ptr(), rows, h, h, h, blocks, cluster,
            1 if x.dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"B10 launch failed: CUDA error {rc}")
    return call


def _before_call(lib, x, w, r, g, dx, dw, sms):
    """The earlier B10 (`--before`) as its wrapper called it: strips of rows,
    about 4 a SM, an f32 partial [strips, H], a second kernel for dw."""
    rows, h = x.shape
    want = max(1, min(rows, 4 * sms))
    per = -(-rows // want)
    strips = max(1, -(-rows // per))
    part = torch.empty(strips, h, dtype=torch.float32, device=x.device)

    def call():
        rc = lib.pt_rms_norm_bwd(
            x.data_ptr(), w.data_ptr(), r.data_ptr(), g.data_ptr(),
            dx.data_ptr(), part.data_ptr(), dw.data_ptr(), rows, h, h, h,
            per, strips, 1 if x.dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"B10 (before) launch failed: CUDA error {rc}")
    return call, (per, strips)


def _case(dev, rows, h):
    gen = torch.Generator(device=dev).manual_seed(6)
    scale = 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 5 - 4)
    x = (torch.randn(rows, h, generator=gen, device=dev) * scale).bfloat16()
    w = (torch.randn(h, generator=gen, device=dev) * 0.5 + 1).bfloat16()
    g = torch.randn(rows, h, generator=gen, device=dev).bfloat16()
    _, r = rn.rms_norm_fwd_plain(x, w, EPS)
    return x, w, g, r.contiguous()


def _ratios(dx, dw, rdx, rdw):
    """dx's worst row and dw over their bars (chip_smoke's: 2^-6 of the
    row's largest entry, 2^-7 of dw's largest)."""
    d = (dx.float() - rdx.float()).abs().amax(-1)
    bar = (2.0**-6 * rdx.float().abs().amax(-1)).clamp_min(1e-30)
    dwr = ((dw.float() - rdw.float()).abs().max()
           / (2.0**-7 * rdw.float().abs().max())).item()
    return (d / bar).max().item(), dwr


def _checked(what, call, dx, dw, ref):
    call()
    torch.cuda.synchronize()
    rx, rw = _ratios(dx, dw, *ref)
    if not (rx <= 1.0 and rw <= 1.0):
        raise AssertionError(f"B10 {what}: dx at {rx}, dw at {rw} of the bar")
    return f"dx at {rx:.3f}, dw at {rw:.3f} of their bars"


def _graph_ms(fn, reps=100):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / reps


def _methods(fn, l2):
    return ", ".join(f"{how} flush{' + sleep' if sleep else ''} {t:.4f}"
                     for (how, sleep), t in timing.methods_ms(fn, l2).items())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", type=Path, default=None,
                    help="an earlier rms_norm.cu to time beside this one")
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    l2 = timing.ColdL2(dev)
    _print_resources("this tree", _build.build("rms_norm")[1])
    lib = _build.lib("rms_norm")
    before = None
    if args.before is not None:
        so, report = _build_copy(args.before.read_text(), "rms_norm_before",
                                 args.before.parent)
        if so is None:
            raise RuntimeError(f"{args.before}: nvcc failed:\n{report}")
        before = _load(so, "pt_rms_norm_bwd", BEFORE_SIGNATURE)
    variants = _variants()

    for rows, h in SHAPES:
        x, w, g, r = _case(dev, rows, h)
        ref = rn.rms_norm_bwd_plain(x, w, r, g)
        dx = torch.empty_like(x)
        dw = torch.empty_like(w)
        grid = rn.bwd_grid(rows, h, 2, sms)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        yl = torch.nn.functional.rms_norm(xl, (h,), wl, EPS)

        def library():
            return torch.autograd.grad(yl, (xl, wl), g, retain_graph=True)

        def wrapper():
            return rn.rms_norm_bwd(x, w, r, g)

        print(f"B10 [{rows}, {h}] bf16: plan (R, NV, G, S) "
              f"{rn.bwd_plan(h, 2)}, grid (blocks, cluster) {grid}; bound "
              f"{(3 * rows * h * 2 + 4 * h + 4 * rows) / 3.35e12 * 1e3:.4f} "
              f"ms at 3.35 TB/s; F.rms_norm's backward "
              f"{timing.cold_ms(library, l2):.4f} ms", flush=True)
        got = wrapper()
        torch.cuda.synchronize()
        rx, rw = _ratios(*got, *ref)
        print(f"  the wrapper: dx at {rx:.3f}, dw at {rw:.3f} of their bars; "
              f"by method (ms): {_methods(wrapper, l2)}; from a CUDA graph "
              f"{_graph_ms(wrapper):.4f} ms", flush=True)
        if before is not None:
            call, strips = _before_call(before, x, w, r, g, dx, dw, sms)
            print(f"  before (rows a strip, strips) {strips}: "
                  f"{_checked('before', call, dx, dw, ref)}; by method "
                  f"(ms): {_methods(call, l2)}; from a CUDA graph "
                  f"{_graph_ms(call):.4f} ms", flush=True)
        grids = ((grid, (128, 4), (132, 2), (132, 1), (sms // 2 // 2 * 2, 2))
                 if rows >= 1024 else (grid, (2, 1), (8, 1), (8, 2)))
        for blocks, cluster in grids:
            call = _call(lib, x, w, r, g, dx, dw, blocks, cluster)
            print(f"  {blocks} blocks in clusters of {cluster}: "
                  f"{timing.cold_ms(call, l2):.4f} ms, "
                  f"{_checked('grid', call, dx, dw, ref)}", flush=True)
        for label, vlib in variants.items():
            call = _call(vlib, x, w, r, g, dx, dw, *grid)
            print(f"  {label}: {timing.cold_ms(call, l2):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
