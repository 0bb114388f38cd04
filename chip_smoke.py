#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure raises and the script exits non-zero:

  1. build        compile the four CUDA sources of
                  `paddle_tpu_torch/kernels/csrc`, one nvcc each, all started
                  together; count the HGMMA (wgmma) instructions of every
                  instantiation of the TMA kernels (B1, B2, B3, B8's
                  prefill) and the HMMA (mma.sync) instructions of B5's,
                  B4's and B6/B7's (decode_mma_kernel, by key source:
                  CacheKeys for B4, PagedKeys for B6/B7) and B8's GEMV
                  kernels in their SASS (cuobjdump); B2's, B3's, B4-B7's,
                  the GEMV's and B10's must compile without spills (ptxas'
                  report).
  2. parity       each kernel against its plain PyTorch version on the same
                  inputs, each error beside its bar: B4 decode (also at
                  B4_CASES: a 1029-key cache, g 1-64, both head dims, rows
                  at 0, mid-tile and len - 1, in bf16 each output vector
                  against the plain version run in f32, a second call
                  bit-identical, and the same bits over a cache holding
                  NaN past each row's pos; GPT-2's decode shape, 12 heads
                  of 64, len 1024, and its 64-row prefill bucket for B5;
                  then planted faults the B4 bar
                  must reject: a split dropped, a split's weight wrong, a
                  key past a row's end, V past pos left in P V), B5 window, B6
                  paged decode, B7 paged decode over int8 pages (ps 16 and 64,
                  GQA), B8 weight-only int8 matmul (the four decode shapes,
                  prefill M 512 and 2048, ragged M/K/N), in bf16 and f32;
                  B5 at the edges of its key split and row tiles
                  (B5_CASES) and B8's GEMV at M 1-16 with the four decode
                  (K, N), a K tail, N off the vector gate and a weight off
                  16-byte alignment, each output vector also within its own
                  bar of the plain version run in f32 and a second call
                  bit-identical; planted faults the B5 bar must reject (a
                  key split dropped, splits combined without the max
                  rescale, the keys of a split wholly past a row's limit at
                  exp(0), the last partial tile unmasked); B6 and B7 at the
                  edges of their key split (PAGED_CASES: pages of 8-128,
                  g 1-64, rows at 0, 1, mid-page and the full table), in
                  bf16 each output vector also against the plain version
                  run in f32 and a second call bit-identical, then planted
                  faults the B6/B7 bar must reject (the middle of a row's
                  key splits dropped, a split's weight wrong, the last key
                  of a row off by one, B7: a scale from the wrong page);
                  B8's prefill routes in bf16 at their tile edges (M 17-2047
                  with the four serving (K, N), a ragged shape on the TMA
                  gate, two off it: K % 8 != 0, x 2 bytes off alignment),
                  each call's route read off the counters, then planted
                  faults B8's bar must reject (a K tile of the weight left
                  out, one column tile's scales from its neighbour, the /127
                  missing, the K tail left out, every scale from the next
                  channel), at a prefill shape and at a GEMV shape with a K
                  tail (per row); B1 flash forward and B2 + B3 flash
                  backward (the 7B leg's micro-batch, GQA up to groups of
                  8, non-causal,
                  cross-length, ragged, rows that see no key, 129 rows over
                  127 keys and 65 over 129, head_dim 64, f32), each output
                  vector within its own bar;
                  then planted faults that the B1-B3 bar must reject; B9 and
                  B10 (RMSNorm forward and backward) at the training legs'
                  micro-batches, the decode rows, a ragged row count and in
                  f32, each row of y and dx within its bar, B10 twice with
                  the same bits and one launch a call, then planted faults
                  their bars must reject (B10's dw: a row group left out, a
                  cluster's partial counted twice or left out).
  2'. c2          fault C2: one row through B4, B5, B6 and B7 in bf16 alone,
                  among 7 rows with the batch's max_pos and among 3 with pos
                  on the card (7B's and GPT-2's decode shapes), bit-identical
                  outputs; one x row through B8's GEMV at M 1, 8, 9 and 16.
      c3          fault C3: B10 on two streams at once, each call its solo
                  bits.
      tune        the block tuner on B8's tile (M 2048 and 8192, K 4096, N
                  11008), on an empty cache: measured, a cache hit, read from
                  disk, the PADDLE_TUNE_BLOCKS pin; the output within B8's
                  bar under each pick.
  2a. train-check the loss and full grad tree of `forward_and_loss` (B1-B3,
                  fused CE) at Llama-2-7B width, 2 layers, s 1024, against an
                  f32 forward written here (materialized attention, unfused
                  CE, plain autograd): f32 weights, then the same weights in
                  bf16 through the bf16 kernels, beside the plain bf16
                  attention (use_flash=False).
  2a'. eager      the eager surface (`import paddle_tpu_torch as paddle`):
                  a to_tensor with no place lands on cuda:0; a Llama loss
                  written against the surface (`eager_llama_loss`:
                  index_select, mean/rsqrt, split/concat RoPE,
                  nn.functional.flash_attention, sigmoid SwiGLU,
                  logsumexp/take_along_axis CE) at Llama-2-7B width, 2
                  layers, b 1 s 2048, causal, against `forward_and_loss`
                  (remat off) on the same weights: f32 loss rel <= 1e-5 and
                  worst grad leaf <= 1e-3, bf16 loss rel <= 1e-3; B1
                  launched >= 2 times in its forward, B2 and B3 >= 2 in its
                  backward. The bf16 step's ms, aten ops and device-busy
                  share beside the functional path's (recorded).
  2b. train       `HybridParallelEngine` on the 7B-width training leg of
                  bench.py (4 layers, b4 s2048, 2 micro-batches, no remat,
                  loss_chunk 128, bf16 params, f32 moments): 2 warm-up and 8
                  timed steps, B1-B3 launched L·M = 8 times each a step and
                  B9/B10 (2L+1)·M = 18; then 2 steps under torch.profiler
                  (where the time goes, the norms' share among it).
                  The engine's default training monitor reports every
                  step: its MFU (dispatch time) beside the synchronised
                  MFU, its HBM gauge equal to torch.cuda.max_memory_allocated.
  2c. train-h2048 the same for bench.py's primary leg (h2048, 16 layers, b8
                  s1024, 2 micro-batches).
  2d. ckpt        checkpoints at Llama-2-7B width (2 layers, f32 params and
                  moments, B1-B3, B9, B10; b2 s1024): 5 steps saving every 2
                  (keep 2); a child process killed (PADDLE_CHAOS, os._exit)
                  inside step 4's save leaves committed_steps() == [2];
                  resume=True gives steps 2-4 the uninterrupted losses bit
                  for bit. Snapshot ms, write MB/s and GB on disk printed.
  3. engine       `PagedEngine` at Llama-2-7B width (32 layers, bf16, random
                  weights from a seed) serves 12 requests with a shared system
                  prefix (radix hits, one mid-page COW split), a short suffix
                  (B5 in paged prefill) and two sampled requests; the kernel
                  launch counters must grow. Then a profiled decode window
                  (B9 once a norm: 65 launches a decode step; B6 once a
                  layer, B7 in the int8 one; no more launches a step than
                  before B6/B7 ran over clusters).
  3a. disagg      disaggregated prefill/decode on the 7B model: (a) bf16, the
                  engine phase's 12 requests through `DisaggServer` over
                  `LocalTransport`: each shipped page bit-identical in the
                  decode worker's pool, first tokens equal to the engine
                  phase's, both workers drained; (b) f32, 2 layers at 7B
                  width, greedy, int8 pool and chunked (256): tokens equal
                  to the monolithic `PagedEngine`'s; (c) bench.py's disagg
                  leg at its TPU settings (8 slots, pages of 64, chunks of
                  256; a steady 128-token stream through a 4 x 1536-token
                  burst): the stream's tokens per scheduler step within
                  0.9-1.1 of its base; hand-off MB and latency, decode step
                  ms and the monolithic counterfactual recorded.
  3b. router      one `Router` over the 7B `PagedEngine` (bf16, 2 slots: a
                  batch slot is preempted), GPT-2 small (`GptEngine`) and
                  BERT-base (`BertBackend`) on bench.py's router trace at 16x
                  its prompt lengths: every request finishes, preemptions =
                  resumes >= 1; GPT-2 alone launches B4 and B5 and nothing
                  else; GPT-2 f32 `GptEngine` equal to `gpt_generate`, its
                  bf16 logits against a plain f32 forward (the logits bars);
                  BERT-base bf16 pooled within rel 0.05 of f32; a preempted
                  and resumed f32 request (7B width, 2 layers) equal to its
                  uninterrupted run. Tokens/s, TTFT p50 per model and SLO
                  class and BERT's embed step recorded.
  4. logits       one request's prompt + generated tokens through prefill and
                  `paged_decode_step` against a plain f32 full-sequence forward
                  of the same bf16 weights; then the same with the weights in
                  f32, to a bar that leaves room only for summation order.
      logits-cuts (not run by default; needs engine) the bf16 check
                  recorded, not held, with the decode rows' keys cut over
                  1-4 splits: how far it moves with one kernel's rounding.
  5. generate     `generate` at b=4 (48- and 128-token prompts), the stripe
                  path that runs B4 and B5.
  5a. chunked     chunked prefill against monolithic prefill on the mixed
                  trace at bench.py's TPU settings (a 2 x 1536-token burst in
                  32 short prompts): short-request TTFT, chunk counts.
  5b. spec        speculative decoding at bench.py's settings (h2048, 16
                  layers, a 4-layer draft): f32 output equal to plain greedy,
                  bf16 tokens/s of both; then at Llama-2-7B width with its
                  4-layer draft, the block tables after all-rejected rounds
                  held to a plain engine's.
  6. engine-int8  `quantize_params` of the bf16 model, on the card, serving the
                  same traffic through `PagedEngine(kv_dtype="int8")`: B5, B7
                  and B8 must launch (B8's TMA route > 0 times, its off-gate
                  route 0 times), the prefix-cache counters equal the bf16
                  run's, the pool holds <= 0.51x its bytes. Then a profiled
                  decode window and `generate` over the int8 weights (B4, B8).
  7. logits-int8  as 4 for the int8 weights, against the f32 forward of their
                  dequantized values (q * scale / 127): (a) with the bf16 pool;
                  (b) with the int8 pool, against that forward with the pool's
                  rounding written out independently of the port, in bf16 and
                  (to the f32 bars) in f32.
  8. capacity     the reference's equal-KV-bytes leg (bench.py
                  `_bench_int8_kv_pool`, TPU settings) at 7B width: a 48-page
                  bf16 pool against the int8 pool of the same bytes on one
                  48-request trace; sustained slots must reach >= 1.8x.
  9. timing       CUDA-event medians of each kernel, its plain version and one
                  PyTorch library call (`timing.METHOD`: the L2 flushed
                  before each call by reading 256 MB, the card held busy
                  while the host enqueues it; B4, B6, B7 and B10 also under
                  all four methods of `timing.METHODS`, and B4's shared
                  body beside its cluster kernel; the card's clocks logged
                  before and after) at the serving shapes
                  (B1-B3, B9, B10:
                  the 7B training leg's micro-batch; B2/B3 also at the h2048
                  leg's, B9/B10 also at the h2048 leg's micro-batch and
                  the decode rows; B4 also at the speculative draft's
                  1029-key stripe; B5 also at the
                  spec-verify window; B6 and B7 also at the engine's decode
                  shape, 8 rows of 257-320 keys; B8's GEMV at the four
                  decode shapes at M 1, 8 and 16), beside the bound the
                  card's memory rate or peak sets.

The line before the card line is {"kernels": [...]}; then the card's name and
power limit from nvidia-smi; the last line is the device JSON. Without a CUDA
device, or without the package beside it, the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ATTN_SRC = "paddle_tpu_torch/kernels/csrc/attention.cu"
QMM_SRC = "paddle_tpu_torch/kernels/csrc/quantized_matmul.cu"
FLASH_SRC = "paddle_tpu_torch/kernels/csrc/flash_attention.cu"
RMS_SRC = "paddle_tpu_torch/kernels/csrc/rms_norm.cu"
REF = "paddle_tpu/kernels/quantized_matmul.py"
FLASH_REF = "paddle_tpu/kernels/flash_attention.py"
RMS_REF = "paddle_tpu/kernels/rms_norm.py"
KERNELS = {   # launch-count key -> (JSON name, source, the Pallas kernel)
    "flash_fwd": ("B1 flash_fwd", FLASH_SRC, f"{FLASH_REF}:112"),
    "flash_bwd_dq": ("B2 flash_bwd_dq", FLASH_SRC, f"{FLASH_REF}:215"),
    "flash_bwd_dkv": ("B3 flash_bwd_dkv", FLASH_SRC, f"{FLASH_REF}:260"),
    "decode_attention": ("B4 decode_attention", ATTN_SRC, f"{REF}:253"),
    "window_attention": ("B5 window_attention", ATTN_SRC, f"{REF}:363"),
    "paged_decode_attention": ("B6 paged_decode_attention", ATTN_SRC,
                               f"{REF}:529"),
    "paged_decode_attention_int8": ("B7 paged_decode_attention (int8 pool)",
                                    ATTN_SRC, f"{REF}:595"),
    "weight_only_matmul": ("B8 weight_only_matmul", QMM_SRC, f"{REF}:101"),
    "weight_only_matmul_prefill": ("B8 weight_only_matmul (prefill M=2048)",
                                   QMM_SRC, f"{REF}:101"),
    "rms_norm_fwd": ("B9 rms_norm_fwd", RMS_SRC, f"{RMS_REF}:34"),
    "rms_norm_bwd": ("B10 rms_norm_bwd", RMS_SRC, f"{RMS_REF}:42"),
}
# kernel vs plain version: max |difference| <= TOL * max(1, max |plain|)
# (B1-B3: per vector, `flash_row_ratio`). bf16: two units in the last place at the largest output (2 * 2^-7); the
# attention plain versions round scores, probabilities and (B7) the
# dequantized K/V to bf16 where the kernels keep f32; B8's plain version
# rounds every dequantized weight and its output to bf16 where the kernel
# sums exact codes in f32 and rounds once. They may differ by a rounding or
# two. f32: both compute in f32 and sum in different orders.
TOL = {"bfloat16": 2.0**-6, "float32": 1e-5}
# launch counters that must read 0 after the main path: B8's wmma tiles
# serve only shapes off the TMA gate, which no main-path shape is
OFF_PATH = ("weight_only_matmul_offgate",)


def log(msg):
    print(msg, flush=True)


def launch_counts():
    """Every wrapper's launch count, by key of KERNELS."""
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import rms_norm as rn

    return {**fa.launches, **at.launches, **qm.launches, **rn.launches}


def reset_launches():
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import rms_norm as rn

    at.reset_launches()
    fa.reset_launches()
    qm.reset_launches()
    rn.reset_launches()


def peaks(name):
    """(bytes/s, bf16 flop/s) of the card: the port's one peak table
    (`observability/hardware.py`), which the training monitor reads too."""
    from paddle_tpu_torch.observability import hardware

    rates = hardware.peaks_for(name)
    if rates is None:
        raise RuntimeError(f"no peak rates recorded for {name!r}")
    return rates


# ---------------------------------------------------------------------------
# inputs at the serving shapes
# ---------------------------------------------------------------------------


def paged_case(torch, dev, dtype, b=8, nh=32, nkv=32, hd=128, ps=16, P=128,
               pos=(2047, 1500, 777, 513, 64, 17, 1, 0), seed=0):
    """A pool holding b rows of P pages each under shuffled page ids (page 0
    is the null page), ragged positions."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * P
    shape = (n_pages, nkv, ps, hd)
    pool_k = torch.randn(shape, device=dev, generator=g).to(dtype)
    pool_v = torch.randn(shape, device=dev, generator=g).to(dtype)
    perm = torch.randperm(n_pages - 1, device=dev, generator=g) + 1
    bt = perm.reshape(b, P).to(torch.int32).contiguous()
    q = torch.randn(b, 1, nh, hd, device=dev, generator=g).to(dtype)
    pos_t = torch.tensor(pos[:b], dtype=torch.int32, device=dev)
    return q, pool_k, pool_v, bt, pos_t


def paged_q8_case(torch, dev, dtype, ps=16, nkv=32, P=None, **kw):
    """paged_case's rows over an int8 pool of the same keys (P pages a
    row, 2048 keys by default): codes in [-127, 127], scales in [0.5,
    2.5]; one page of row 1 has scale 0 (a fresh page). Returns q,
    codes_k, codes_v, k_scale, v_scale, bt, pos."""
    q, _, _, bt, pos = paged_case(torch, dev, dtype, ps=ps, nkv=nkv,
                                  P=P or 2048 // ps, **kw)
    g = torch.Generator(device=dev).manual_seed(3)
    n_pages = 1 + bt.numel()
    shape = (n_pages, nkv, ps, q.shape[-1])

    def half():
        codes = torch.randint(-127, 128, shape, generator=g, device=dev,
                              dtype=torch.int8)
        sc = torch.rand(n_pages, nkv, generator=g, device=dev) * 2 + 0.5
        sc[bt[1, 0]] = 0.0
        return codes, sc

    (kq, ks), (vq, vs) = half(), half()
    return q, kq, vq, ks, vs, bt, pos


def matmul_case(torch, dev, dtype, m, k, n, seed=4):
    """x [m, k] ~ N(0, 1) and the int8 codes and scales of a N(0, 0.02)
    weight [k, n], quantized on the card."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=dev).to(dtype)
    w, s = qm.quantize_absmax(torch.randn(k, n, generator=g, device=dev)
                              * 0.02)
    return x, w, s


# B8's shapes on one decode step of Llama-2-7B: (K, N, calls a step)
DECODE_MATMULS = ((4096, 4096, 4 * 32), (4096, 11008, 2 * 32),
                  (11008, 4096, 32), (4096, 32000, 1))


def window_case(torch, dev, dtype, s, b=2, nh=32, nkv=32, hd=128,
                length=2048 + 64, pos=None, seed=1):
    """A scratch stripe like paged prefill's (pages + bucket padding); row 0's
    window overhangs the cache end."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ck = torch.randn(b, nkv, length, hd, device=dev, generator=g).to(dtype)
    cv = torch.randn(b, nkv, length, hd, device=dev, generator=g).to(dtype)
    q = torch.randn(b, s, nh, hd, device=dev, generator=g).to(dtype)
    pos = pos if pos is not None else [length - s // 2, 512][:b]
    return q, ck, cv, torch.tensor(pos, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    built = _build.build_all()
    for name in built:
        _build.lib(name)
    srcs = sorted(str(p.relative_to(ROOT)) for p, _ in built.values())
    log(f"[build] {srcs} in {time.perf_counter() - t0:.1f} s (one nvcc a "
        f"source, in parallel)")
    for _, report in built.values():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"[build] {line.strip()}")
    spill_check(built)
    sass_check(built)


# the tensor-core instruction each redesigned kernel must run, by library:
# {library: {name fragment: SASS opcode}} (HGMMA: wgmma; HMMA: mma.sync).
# decode_mma_kernel's instantiations go by their key source: CacheKeys (B4:
# TMA copies of the contiguous cache), PagedKeys (B6/B7: cp.async copies
# through the block table)
TENSOR_CORE_KERNELS = {
    "quantized_matmul": {"b8_tma_kernel": "HGMMA",
                         "b8_gemv_mma_kernel": "HMMA"},
    "flash_attention": {"flash_fwd_tma_kernel": "HGMMA",
                        "flash_bwd_dq_tma_kernel": "HGMMA",
                        "flash_bwd_dkv_tma_kernel": "HGMMA"},
    "attention": {"window_mma_kernel": "HMMA",
                  "CacheKeys": "HMMA", "PagedKeys": "HMMA"}}
# the kernels whose every instantiation must compile without spills, by
# library
SPILL_FREE = {"flash_attention": ("flash_bwd_dq_tma_kernel",
                                  "flash_bwd_dkv_tma_kernel"),
              "attention": ("window_mma_kernel", "decode_mma_kernel"),
              "quantized_matmul": ("b8_gemv_mma_kernel",),
              "rms_norm": ("rms_norm_bwd_kernel",)}


def spill_check(built):
    """Spill bytes of each SPILL_FREE kernel's instantiations, read from
    ptxas' report (-Xptxas=-v) of its library; raises when one spills or
    fewer than two are reported. An empty report (the library was built
    before) is said so and skipped."""
    import re

    for lib, frags in SPILL_FREE.items():
        report = built[lib][1]
        if not report:
            log(f"[build] {lib}: spills not checked: the library was "
                "already built")
            continue
        spills, fn = {}, None
        for line in report.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function "
                          r"properties for )([^' ]+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and fn:
                spills[fn] = int(m.group(1)) + int(m.group(2))
        for frag in frags:
            mine = {f: n for f, n in spills.items() if frag in f}
            log(f"[build] {frag}: spill bytes by instantiation "
                f"{sorted(mine.values())}")
            if len(mine) < 2 or any(mine.values()):
                raise AssertionError(f"{frag}: spills or no ptxas report "
                                     f"for its instantiations: {mine}")


def sass_check(built):
    """Tensor-core instructions (TENSOR_CORE_KERNELS) in each redesigned
    kernel's SASS, read with cuobjdump from the libraries just built;
    raises when an instantiation has none. Skipped, and said so, where the
    toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("[build] HGMMA/HMMA counts not checked: no cuobjdump")
        return
    for lib, frags in TENSOR_CORE_KERNELS.items():
        sass = subprocess.run([tool, "-sass", str(built[lib][0])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
            elif fn:
                for op in counts[fn]:
                    if f" {op}." in line or f" {op} " in line:
                        counts[fn][op] += 1
        for frag, op in frags.items():
            mine = {f: c[op] for f, c in counts.items() if frag in f}
            log(f"[build] {frag}: {op} instructions by instantiation "
                f"{sorted(mine.values())}")
            if not mine or not all(mine.values()):
                raise AssertionError(f"{frag}: an instantiation without "
                                     f"{op} in its SASS: {mine}")


def phase_parity(torch, dev):
    """Kernel vs plain version; returns {wrapper: max_abs_err of its main
    serving case}."""
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    main_err = {}

    def check(label, name, fn, plain, args, main=False, rows=False):
        out = fn(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        dname = str(args[0].dtype).replace("torch.", "")
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[dname] * max(1.0, ref.float().abs().max().item())
        extra = ""
        if rows:
            # each output vector against the plain version run in f32 on
            # the same inputs (`row_ratio`), and a second call bit for bit
            ratio = row_ratio(torch, out, plain, args, dname)
            again = torch.equal(fn(*args), out)
            extra = (f", worst row at {ratio:.3f} of its bar, a second call "
                     f"{'bit-identical' if again else 'DIFFERENT'}")
            if not (ratio <= 1.0 and again):
                raise AssertionError(f"{label}: a row disagrees with the "
                                     f"plain version ({ratio}) or the "
                                     f"output is not reproducible")
        log(f"[parity] {label}: max_abs_err {err:.3e} (bar {tol:.3e}){extra}")
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"{label}: kernel disagrees with its plain "
                                 f"version ({err} > {tol})")
        if main:
            main_err[name] = err

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        main = dtype == torch.bfloat16
        for nkv in (32, 8):
            q, pk, pv, bt, pos = paged_case(torch, dev, dtype, nkv=nkv)
            check(f"B6 {dname} b=8 nh=32 nkv={nkv} ps=16 P=128",
                  "paged_decode_attention",
                  at.paged_decode_attention, at.paged_decode_attention_plain,
                  (q, pk, pv, bt, pos), main and nkv == 32, rows=main)
            ck = at.paged_gather(pk, bt)
            cv = at.paged_gather(pv, bt)
            check(f"B4 {dname} b=8 nh=32 nkv={nkv} len=2048",
                  "decode_attention",
                  at.decode_attention, at.decode_attention_plain,
                  (q, ck, cv, pos), main and nkv == 32, rows=main)
        for s, nkv in ((16, 32), (64, 32), (16, 8)):
            q, ck, cv, pos = window_case(torch, dev, dtype, s, nkv=nkv)
            check(f"B5 {dname} s={s} nkv={nkv} len={ck.shape[2]} "
                  f"pos={pos.tolist()} (row 0 overhangs)", "window_attention",
                  at.window_attention, at.window_attention_plain,
                  (q, ck, cv, pos), main and s == 16 and nkv == 32, rows=True)
        for label, *shape in B5_CASES:
            q, ck, cv, pos = b5_case(torch, dev, dtype, *shape)
            splits = at.window_splits(at._window_last(pos, shape[1],
                                                      shape[5]))
            check(f"B5 {dname} {label}: b={shape[0]} s={shape[1]} "
                  f"nh={shape[2]} nkv={shape[3]} hd={shape[4]} "
                  f"len={shape[5]} pos={shape[6]}, "
                  f"{splits if dtype == torch.bfloat16 else 1} split(s)",
                  "window_attention", at.window_attention,
                  at.window_attention_plain, (q, ck, cv, pos), rows=True)
            del q, ck, cv
    # head_dim 64, the kernels' other instantiation
    q, pk, pv, bt, pos = paged_case(torch, dev, torch.bfloat16, nh=8, nkv=4,
                                    hd=64, P=16,
                                    pos=(255, 100, 3, 0, 9, 77, 31, 16))
    check("B6 bfloat16 hd=64 nkv=4", "paged_decode_attention",
          at.paged_decode_attention, at.paged_decode_attention_plain,
          (q, pk, pv, bt, pos))

    def q8(q, kq, vq, ks, vs, bt, pos):
        return at.paged_decode_attention(q, kq, vq, bt, pos, k_scale=ks,
                                         v_scale=vs)

    def q8_plain(q, kq, vq, ks, vs, bt, pos):
        return at.paged_decode_attention_plain(q, kq, vq, bt, pos,
                                               k_scale=ks, v_scale=vs)

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        main = dtype == torch.bfloat16
        # B7 at the engine's pages (16), the capacity leg's (64), and GQA
        for nkv, ps in ((32, 16), (32, 64), (8, 16)):
            check(f"B7 {dname} b=8 nh=32 nkv={nkv} ps={ps} P={2048 // ps} "
                  f"(a page at scale 0)", "paged_decode_attention_int8", q8,
                  q8_plain, paged_q8_case(torch, dev, dtype, ps=ps, nkv=nkv),
                  main and nkv == 32 and ps == 16, rows=main)
        # B6 and B7 at the edges of paged_mma_kernel's design: in bf16 each
        # output vector also against the plain version run in f32 and a
        # second call bit-identical; f32 runs the shared body
        for label, *shape in PAGED_CASES:
            b, nh, nkv, hd, ps, P, pos = shape
            splits = at.paged_splits(P, ps) if main else 0
            for quant in (False, True):
                args, kw = paged_cases(torch, dev, dtype, *shape, q8=quant)
                check(f"{'B7' if quant else 'B6'} {dname} {label}: b={b} "
                      f"nh={nh} nkv={nkv} hd={hd} ps={ps} P={P} pos={pos}, "
                      + (f"{splits} split(s)" if main else "the shared body"),
                      "paged_decode_attention" + ("_int8" if quant else ""),
                      lambda *a, kw=kw: at.paged_decode_attention(*a, **kw),
                      lambda *a, kw=kw: at.paged_decode_attention_plain(
                          *a, **kw), args, rows=main)
                del args, kw
        # B8: the decode step's four shapes at M = 8, two prefill M, ragged
        for m, k, n in [(8, k, n) for k, n, _ in DECODE_MATMULS] + [
                (512, 4096, 4096), (2048, 4096, 11008), (13, 1000, 999),
                (77, 1000, 999)]:
            check(f"B8 {dname} M={m} K={k} N={n}", "weight_only_matmul",
                  qm.weight_only_matmul, qm.dequant_matmul_plain,
                  matmul_case(torch, dev, dtype, m, k, n),
                  main and (m, k, n) == (8, 4096, 11008),
                  rows=m <= qm.GEMV_MAX_ROWS)
        # B8's GEMV at its edges: every M of a decode batch with the four
        # decode (K, N), K = 1000 (a K tail) and N = 999 off the vector
        # gate, and a weight 1 byte off 16-byte alignment
        for m in B8_GEMV_M:
            for k, n, w_off in [(k, n, 0) for k, n in B8_PAIRS] + [
                    (1000, 4096, 0), (4096, 999, 0), (4096, 4096, 1)]:
                x, w, sc = matmul_case(torch, dev, dtype, m, k, n)
                if w_off:
                    w = b8_offset_w(torch, w)
                split = (qm.gemv_split(k, n, qm._sms(dev))
                         if dtype == torch.bfloat16 else qm._k_split(
                             k, n, dev))
                check(f"B8 GEMV {dname} M={m} K={k} N={n}"
                      + (", w 1 byte off 16-byte alignment" if w_off else "")
                      + f", (K rows a block, blocks) {split}",
                      "weight_only_matmul", qm.weight_only_matmul,
                      qm.dequant_matmul_plain, (x, w, sc), rows=True)
                del x, w, sc
    phase_b4_parity(torch, dev)
    phase_b5_bar_teeth(torch, dev)
    phase_paged_bar_teeth(torch, dev)
    phase_b4_bar_teeth(torch, dev)
    main_err.update(phase_b8_routes(torch, dev, check))
    phase_b8_bar_teeth(torch, dev)
    phase_b8_bar_teeth(torch, dev, shape=(8, 1000, 4096))
    main_err.update(phase_flash_parity(torch, dev))
    phase_flash_bar_teeth(torch, dev)
    main_err.update(phase_rms_parity(torch, dev))
    return main_err


# B8's prefill regime at the edges of its tiles (128 rows, 128 or 256
# columns, 64 K a stage): every M with the main path's four (K, N) pairs,
# then a ragged shape on the TMA gate and two off it, each with the route
# it must take
B8_EDGE_M = (17, 100, 129, 512, 1500, 2047)
B8_PAIRS = tuple((k, n) for k, n, _ in DECODE_MATMULS)


# rows of x the GEMV's parity cases take (M <= 16)
B8_GEMV_M = (1, 4, 8, 9, 16)


def row_ratio(torch, out, plain, args, dname):
    """`flash_row_ratio` of a kernel's output against its plain version run
    in f32 on the same inputs (floating inputs upcast). In bf16 the plain
    version rounds its scores (B5, as the reference's XLA oracle does) or
    its dequantized weights (B8) to bf16 where the kernels keep f32, which
    alone moves a vector by up to about the bar; the f32 run is the exact
    function the kernel rounds once."""
    ref = plain(*[a.float() if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in args])
    return flash_row_ratio(torch, out, ref, TOL[dname])


def b8_offset_w(torch, w):
    """w's codes in a view whose data starts 1 byte past a 16-byte
    boundary: contiguous, but no 16-byte load can read it."""
    buf = torch.empty(w.numel() + 16, dtype=w.dtype, device=w.device)
    view = buf[1:1 + w.numel()].view(w.shape)
    view.copy_(w)
    return view


def b8_offset_x(torch, x):
    """x's values in a view whose data starts 2 bytes past a 16-byte
    boundary: contiguous, but no TMA copy can read it."""
    buf = torch.empty(x.numel() + 8, dtype=x.dtype, device=x.device)
    view = buf[1:1 + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def phase_b8_routes(torch, dev, check):
    """B8 bf16 on each route at its edges, within TOL of the plain version,
    each call's route read off the launch counters. Returns the error of
    the prefill row's shape (M=2048, K=4096, N=11008)."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    cases = [(m, k, n, "tma") for m in B8_EDGE_M for k, n in B8_PAIRS]
    cases += [(2048, 4096, 11008, "tma"), (333, 1000, 1008, "tma"),
              (300, 1001, 4096, "mma"), (512, 4096, 4096, "mma offset")]
    errs = {}
    for m, k, n, want in cases:
        x, w, s = matmul_case(torch, dev, torch.bfloat16, m, k, n)
        if want == "mma offset":
            x = b8_offset_x(torch, x)
        way = qm.route(m, k, n, x.dtype, x.data_ptr(), w.data_ptr())
        label = (f"B8 bfloat16 M={m} K={k} N={n}, route {way}"
                 + (f", tile {qm.tile(m, n, qm._sms(dev))}"
                    if way == "tma" else "")
                 + (", x 2 bytes off 16-byte alignment"
                    if want == "mma offset" else ""))
        before = dict(qm.launches)
        check(label, "weight_only_matmul", qm.weight_only_matmul,
              qm.dequant_matmul_plain, (x, w, s))
        took = {key: qm.launches[key] - before[key] for key in before}
        expect = {"weight_only_matmul": 1,
                  "weight_only_matmul_prefill": int(want == "tma"),
                  "weight_only_matmul_offgate": int(want != "tma")}
        if way != want.split()[0] or took != expect:
            raise AssertionError(f"{label}: launches {took}, want the "
                                 f"{want} route")
        if (m, k, n) == (2048, 4096, 11008):
            errs["weight_only_matmul_prefill"] = (
                qm.weight_only_matmul(x, w, s).float()
                - qm.dequant_matmul_plain(x, w, s).float()
            ).abs().max().item()
        del x, w, s
    torch.cuda.empty_cache()
    return errs


def planted_b8_faults(torch, qm, x, w, s, k_tile=64, n_tile=128):
    """B8 outputs with a fault planted, built from the plain version:
    [(fault, faulty, right)]. The bar must reject each."""
    right = qm.dequant_matmul_plain(x, w, s)
    w_gap = w.clone()
    w_gap[k_tile:2 * k_tile] = 0
    s_shift = s.clone()
    s_shift[n_tile:2 * n_tile] = s[:n_tile]
    tail = w.shape[0] % 16 or 16
    w_tail = w.clone()
    w_tail[-tail:] = 0
    return [(f"one {k_tile}-row K tile of the weight left out",
             qm.dequant_matmul_plain(x, w_gap, s), right),
            (f"the scales of one {n_tile}-column tile taken from its "
             "neighbour", qm.dequant_matmul_plain(x, w, s_shift), right),
            ("the /127 missing", right * 127.0, right),
            (f"the K tail (the last {tail} rows) left out",
             qm.dequant_matmul_plain(x, w_tail, s), right),
            ("every scale taken from the next channel",
             qm.dequant_matmul_plain(x, w, s.roll(-1)), right)]


def phase_b8_bar_teeth(torch, dev, shape=(2048, 4096, 11008)):
    """B8's bar rejects planted faults, each printed beside its ratio to
    the bar: at the prefill row's shape the whole-tensor bar (TOL * max(1,
    max |plain|)), at a GEMV shape (M <= 16) the per-row bar."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    x, w, s = matmul_case(torch, dev, torch.bfloat16, *shape)
    gemv = shape[0] <= qm.GEMV_MAX_ROWS
    for fault, wrong, right in planted_b8_faults(torch, qm, x, w, s):
        if gemv:
            ratio = flash_row_ratio(torch, wrong, right, TOL["bfloat16"])
        else:
            bar = TOL["bfloat16"] * max(1.0,
                                        right.float().abs().max().item())
            ratio = (wrong.float() - right.float()).abs().max().item() / bar
        log(f"[parity] B8 {'per-row ' if gemv else ''}bar, planted fault at "
            f"M={shape[0]} K={shape[1]} N={shape[2]}: {fault} is at "
            f"{ratio:.2f} of the bar")
        if not ratio > 1.0:
            raise AssertionError(f"the B8 bar passes a planted fault: "
                                 f"{fault} at {ratio}")
    del x, w, s
    torch.cuda.empty_cache()


# B5 parity cases at the edges of the bf16 kernel's design: (label, b, s,
# nh, nkv, hd, cache length, pos). Row tiles of 16 (s * g = 2, 5, 16, 17,
# 48, 64 query rows a kv head), both head dims, GQA 8/2 at the spec
# window's s = 5, b = 1 and b = 8, pos 0, a watermark one key past a tile
# (and split) edge, a row whose limit ends before a split begins, and a
# window that overhangs the cache end
B5_CASES = (
    ("s*g=2", 1, 2, 32, 32, 128, 600, [300]),
    ("s*g=5 spec verify b=8 ragged", 8, 5, 32, 32, 128, 1100,
     [1000, 3, 64, 59, 0, 500, 127, 777]),
    ("s*g=20 GQA 8/2 s=5 pos 0", 1, 5, 8, 2, 128, 300, [0]),
    ("s*g=16 paged-prefill suffix", 1, 16, 32, 32, 128, 2064, [512]),
    ("s*g=17 hd64, watermark one key past a split edge", 2, 17, 4, 4, 64,
     400, [112, 112]),
    ("s*g=48, rows whose limit ends before a split begins", 1, 48, 8, 8,
     128, 400, [100]),
    ("s*g=64 hd64, row 0 overhangs the cache end", 2, 64, 32, 32, 64, 700,
     [670, 1]),
    ("GPT-2's prefill bucket: s 64, 12 heads, hd 64", 1, 64, 12, 12, 64,
     1024, [0]),
)


def b5_case(torch, dev, dtype, b, s, nh, nkv, hd, length, pos, seed=7):
    g = torch.Generator(device=dev).manual_seed(seed)
    ck = torch.randn(b, nkv, length, hd, device=dev, generator=g).to(dtype)
    cv = torch.randn(b, nkv, length, hd, device=dev, generator=g).to(dtype)
    q = torch.randn(b, s, nh, hd, device=dev, generator=g).to(dtype)
    return q, ck, cv, torch.tensor(pos, dtype=torch.int32, device=dev)


def window_split_plain(torch, at, q, ck, cv, pos, splits, fault=None):
    """B5 computed the way the bf16 kernel splits it, in f32, with each
    row's keys cut over `splits` splits (`attention.cut_keys`, the kernel's
    cut; the bar's planted faults need the count set by hand), a softmax
    partial (m, l, O) a split, combined with the max rescale. `fault`
    plants one of the faults of `planted_b5_faults`."""
    b, s, nh, hd = q.shape
    nkv, length = ck.shape[1], ck.shape[2]
    g = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    out = torch.empty(b, s, nh, hd, dtype=torch.float32, device=q.device)
    for r in range(b):
        p0 = int(pos[r])
        last = min(p0 + s - 1, length - 1)
        k = ck[r].float().repeat_interleave(g, 0)        # [nh, len, hd]
        v = cv[r].float().repeat_interleave(g, 0)
        qs = q[r].float().transpose(0, 1)                # [nh, s, hd]
        limit = (p0 + torch.arange(s, device=q.device)).clamp(max=last)
        parts = []
        tile0 = last // at.WINDOW_TILE * at.WINDOW_TILE
        for z, keys in enumerate(at.cut_keys(last, splits)):
            if keys is None or (fault == "drop" and z == splits // 2):
                continue
            j = torch.arange(keys[0], keys[1] + 1, device=q.device)
            sc = (qs @ k[:, j].transpose(1, 2)) * scale   # [nh, s, keys]
            live = j[None, :] <= limit[:, None]            # [s, keys]
            if fault == "unmasked tail":
                live = live | ((j >= tile0) & (j <= last))[None, :]
            sc = torch.where(live, sc, at.NEG_INF)
            m = sc.amax(-1, keepdim=True)
            p = torch.where(live, torch.exp(sc - m), 0.0)
            dead = ~live.any(-1)                           # [s]
            if fault == "exp(0)" and dead.any():
                # the split's masked keys each at exp(0) = 1, entering the
                # combine at the row's max
                p = torch.where(dead[None, :, None], 1.0, p)
                m = torch.where(dead[None, :, None], float("inf"), m)
            parts.append((m, p.sum(-1, keepdim=True), p @ v[:, j]))
        ms = torch.stack([m for m, _, _ in parts])
        top = ms.where(ms.isfinite(), -ms).amax(0)        # the real max
        ms = torch.where(ms.isinf(), top, ms)
        w = (torch.ones_like(ms) if fault == "no rescale"
             else torch.exp(ms - top))
        den = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        num = sum(wi * oi for wi, (_, _, oi) in zip(w, parts))
        out[r] = (num / den).transpose(0, 1)
    return out.to(q.dtype)


def planted_b5_faults(torch, at, q, ck, cv, pos, splits):
    """B5 outputs with a fault planted, from the split model of the bf16
    kernel (`window_split_plain`): [(fault, faulty, right)]. The per-row
    bar must reject each."""
    right = at.window_attention_plain(q, ck, cv, pos)
    return [(name, window_split_plain(torch, at, q, ck, cv, pos, splits,
                                      fault), right)
            for name, fault in B5_FAULTS.items()]


B5_FAULTS = {"one key split dropped": "drop",
             "the splits combined without the max rescale": "no rescale",
             "the masked keys of a split wholly past a row's limit counted "
             "as exp(0)": "exp(0)",
             "the last partial tile unmasked": "unmasked tail"}


def phase_b5_bar_teeth(torch, dev, case=5, splits=3):
    """The per-row B5 bar rejects planted faults at the parity case whose
    rows end before a split begins (3 splits of its 3 tiles), each beside
    the whole-tensor rule's ratio; the unplanted split model passes."""
    from paddle_tpu_torch.kernels import attention as at

    label, *shape = B5_CASES[case]
    q, ck, cv, pos = b5_case(torch, dev, torch.bfloat16, *shape)
    model = window_split_plain(torch, at, q, ck, cv, pos, splits)
    right = at.window_attention_plain(q, ck, cv, pos)
    ok = flash_row_ratio(torch, model, right, TOL["bfloat16"])
    log(f"[parity] B5 bar at {label}: the split model without a fault is at "
        f"{ok:.3f} of the bar")
    if not ok <= 1.0:
        raise AssertionError(f"B5's split model fails its bar: {ok}")
    for fault, wrong, right in planted_b5_faults(torch, at, q, ck, cv, pos,
                                                 splits):
        ratio = flash_row_ratio(torch, wrong, right, TOL["bfloat16"])
        whole = ((wrong.float() - right.float()).abs().max()
                 / (TOL["bfloat16"]
                    * right.float().abs().max().clamp_min(1.0))).item()
        log(f"[parity] B5 bar, planted fault at {label}: {fault} is at "
            f"{ratio:.2f} of the bar (the whole-tensor rule: {whole:.2f})")
        if not ratio > 1.0:
            raise AssertionError(f"the B5 bar passes a planted fault: "
                                 f"{fault} at {ratio}")


# B6/B7 parity cases at the edges of paged_mma_kernel's design: (label, b,
# nh, nkv, hd, ps, P, pos). Pages of 8 to 128 keys (a 64-key tile over 8
# pages, inside one page), g = 1 to 64 query rows a kv head (rows 0-7 of one
# row tile, all 16, 2 and 4 row tiles), both head dims, rows at 0, 1,
# mid-page and the full table, and a pos past the table's end (the row's
# keys clamp there)
PAGED_CASES = (
    ("ps 8, g=4, a row at 0 and one mid-page", 4, 32, 8, 128, 8, 128,
     (1023, 0, 4, 511)),
    ("ps 16, g=1, ragged to the full table", 4, 32, 32, 128, 16, 64,
     (1023, 1, 600, 17)),
    ("ps 64, g=8, hd 64", 4, 64, 8, 64, 64, 16, (1023, 1, 100, 0)),
    ("ps 128, g=1, the full table and a page edge", 3, 32, 32, 128, 128, 8,
     (1023, 127, 64)),
    ("ps 16, g=12 (one row tile, rows 8-15 kept)", 2, 24, 2, 128, 16, 16,
     (255, 3)),
    ("ps 16, g=32 (two row tiles)", 2, 64, 2, 128, 16, 16, (255, 9)),
    ("ps 16, g=64 (four row tiles), hd 64", 2, 64, 1, 64, 16, 8, (127, 37)),
    ("ps 16, a pos past the table's end", 2, 32, 32, 128, 16, 16,
     (300, 5)),
)


def paged_cases(torch, dev, dtype, b, nh, nkv, hd, ps, P, pos, q8):
    """The inputs of a PAGED_CASES row as `paged_decode_attention`'s
    arguments and keywords: a bf16/f32 pool, or (q8) an int8 pool with its
    scales."""
    if not q8:
        return paged_case(torch, dev, dtype, b=b, nh=nh, nkv=nkv, hd=hd,
                          ps=ps, P=P, pos=pos), {}
    q, kq, vq, ks, vs, bt, pos_t = paged_q8_case(
        torch, dev, dtype, ps=ps, nkv=nkv, P=P, b=b, nh=nh, hd=hd, pos=pos)
    return (q, kq, vq, bt, pos_t), {"k_scale": ks, "v_scale": vs}


def paged_split_plain(torch, at, q, pk, pv, bt, pos, splits, k_scale=None,
                      v_scale=None, fault=None):
    """B6/B7 computed the way paged_mma_kernel splits them, in f32: each
    row's keys [0, min(pos, P * ps - 1)] cut over `splits` splits
    (`attention.cut_keys`, the count set by hand) and read page by page
    through the block table; over an int8 pool the scales folded as the
    kernel folds them (each key's score times its page's sk / 127, its p
    times sv / 127, the codes exact); a softmax partial (m, l, O) a split,
    combined with the max rescale. `fault` plants one of PAGED_FAULTS."""
    b, _, nh, hd = q.shape
    nkv, ps = pk.shape[1], pk.shape[2]
    P = bt.shape[1]
    g = nh // nkv
    scale = 1.0 / math.sqrt(hd)
    q8 = k_scale is not None
    out = torch.empty(b, 1, nh, hd, dtype=torch.float32, device=q.device)
    for r in range(b):
        p0 = int(pos[r])
        last = min(p0, P * ps - 1)
        qs = q[r, 0].float()                                 # [nh, hd]
        parts = []
        cut = at.cut_keys(last, splits)
        held = [z for z, keys in enumerate(cut) if keys is not None]
        # "drop": the middle split of those holding the row's keys
        drop = (held[len(held) // 2] if fault == "drop" and len(held) > 1
                else None)
        for z, keys in enumerate(cut):
            if keys is None or z == drop:
                continue
            end = keys[1]
            if fault == "last key" and end == last:
                end = min(last + 1, P * ps - 1)     # one key past the row
            if fault == "tail" and end == last:
                # the row's last tile to its end, within the keys there are
                end = min((last // at.WINDOW_TILE + 1) * at.WINDOW_TILE,
                          P * ps) - 1
            j = torch.arange(keys[0], end + 1, device=q.device)
            page = bt[r].long()[j // ps]
            k = pk[page, :, j % ps].float().repeat_interleave(g, 1)
            v = pv[page, :, j % ps].float().repeat_interleave(g, 1)
            sc = torch.einsum("hd,nhd->hn", qs, k) * scale   # [nh, keys]
            if q8:
                kpage = (bt[r].long()[(j // ps + 1) % P]
                         if fault == "scale page" else page)
                sc = sc * (k_scale[kpage].repeat_interleave(g, 1).t()
                           / 127.0)
            if fault == "tail":
                sc = torch.where(j <= last, sc, -math.inf)
            m = sc.amax(-1, keepdim=True)
            p = torch.exp(sc - m)
            pw = (p * (v_scale[page].repeat_interleave(g, 1).t() / 127.0)
                  if q8 else p)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("hn,nhd->hd", pw, v)))
        ms = torch.stack([m for m, _, _ in parts])           # [S, nh, 1]
        w = torch.exp(ms - ms.amax(0))
        if fault == "weight":
            # the split with the lowest max at weight 1, not e^(m - M)
            w = torch.where(ms == ms.amin(0), 1.0, w)
        den = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        num = sum(wi * oi for wi, (_, _, oi) in zip(w, parts))
        out[r, 0] = num / den
    return out.to(q.dtype)


# planted faults of the split model, for the B6/B7 bar (the scale fault
# over an int8 pool only)
PAGED_FAULTS = {"the middle of a row's key splits dropped": "drop",
                "a split's weight wrong (the lowest max at weight 1)":
                    "weight",
                "the last key of a row off by one (one key past its end)":
                    "last key",
                "a key's scale taken from the next page of the table":
                    "scale page"}


def planted_paged_faults(torch, at, args, kw, splits):
    """B6 (B7 with the scales in `kw`) outputs with a fault planted, from
    `paged_split_plain`: [(fault, faulty, right)]. The per-row bar must
    reject each."""
    right = at.paged_decode_attention_plain(*args, **kw)
    return [(name, paged_split_plain(torch, at, *args, splits, **kw,
                                     fault=fault), right)
            for name, fault in PAGED_FAULTS.items()
            if kw or fault != "scale page"]


def phase_paged_bar_teeth(torch, dev, case=0, splits=8):
    """The per-row B6/B7 bar rejects planted faults at a ragged case (rows
    at 0 and mid-page, 8 splits: the short rows leave some empty), each
    beside the whole-tensor rule's ratio; the unplanted split model
    passes against the plain version in f32."""
    from paddle_tpu_torch.kernels import attention as at

    label, *shape = PAGED_CASES[case]
    for q8 in (False, True):
        kid = "B7" if q8 else "B6"
        args, kw = paged_cases(torch, dev, torch.bfloat16, *shape, q8=q8)
        model = paged_split_plain(torch, at, *args, splits, **kw)
        exact = at.paged_decode_attention_plain(
            args[0].float(), *[a.float() if a.is_floating_point() else a
                               for a in args[1:]], **kw)
        ok = flash_row_ratio(torch, model, exact, TOL["bfloat16"])
        log(f"[parity] {kid} bar at {label}: the split model without a "
            f"fault is at {ok:.3f} of the bar")
        if not ok <= 1.0:
            raise AssertionError(f"{kid}'s split model fails its bar: {ok}")
        for fault, wrong, right in planted_paged_faults(torch, at, args, kw,
                                                        splits):
            ratio = flash_row_ratio(torch, wrong, right, TOL["bfloat16"])
            whole = ((wrong.float() - right.float()).abs().max()
                     / (TOL["bfloat16"]
                        * right.float().abs().max().clamp_min(1.0))).item()
            log(f"[parity] {kid} bar, planted fault at {label}: {fault} is "
                f"at {ratio:.2f} of the bar (the whole-tensor rule: "
                f"{whole:.2f})")
            if not ratio > 1.0:
                raise AssertionError(f"the {kid} bar passes a planted fault: "
                                     f"{fault} at {ratio}")


# B4 parity cases at the edges of decode_mma_kernel's TMA source: (label,
# b, nh, nkv, hd, cache length, pos). A cache length off the 64-key tile
# (1029: the speculative draft's stripe, max_len + spec_tokens + 1), g = 1,
# 2, 4, 8 (rows 0-7 of one row tile) and 64 (four row tiles), both head
# dims, rows at 0, mid-tile, a tile edge and len - 1, and a pos past the
# cache's end (the row's keys clamp there). Every case runs again over the
# cache with NaN in the slots past each row's pos: the kernel must give the
# bits it gives over the random values there.
B4_CASES = (
    ("the draft's stripe, len 1029, g=1", 8, 16, 16, 128, 1029,
     (1028, 700, 64, 63, 0, 1, 500, 900)),
    ("g=2, len 1029", 4, 32, 16, 128, 1029, (1028, 0, 511, 1000)),
    ("g=4, hd 64", 4, 32, 8, 64, 1029, (64, 1028, 7, 300)),
    ("g=8, len 130", 4, 64, 8, 128, 130, (129, 63, 0, 70)),
    ("g=64 (four row tiles), hd 64", 2, 64, 1, 64, 200, (199, 31)),
    ("a pos past the cache's end", 2, 32, 32, 128, 300, (5000, 299)),
    ("GPT-2's decode: 12 heads, hd 64, len 1024", 8, 12, 12, 64, 1024,
     (1023, 700, 300, 191, 144, 64, 1, 0)),
)


def b4_case(torch, dev, dtype, b, nh, nkv, hd, length, pos, seed=9):
    """q and a random cache [b, nkv, length, hd] in `dtype`, and the same
    cache with NaN in every slot past each row's pos (the unwritten slots
    of a stripe); returns q, ck, cv, ck_nan, cv_nan, pos."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (b, nkv, length, hd)
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    live = (torch.arange(length, device=dev)[None, :]
            <= pos_t[:, None].long())[:, None, :, None]
    ck = torch.randn(shape, generator=g, device=dev).to(dtype)
    cv = torch.randn(shape, generator=g, device=dev).to(dtype)
    q = torch.randn(b, 1, nh, hd, generator=g, device=dev).to(dtype)
    nan = torch.tensor(float("nan"), device=dev, dtype=dtype)
    return (q, ck, cv, torch.where(live, ck, nan), torch.where(live, cv, nan),
            pos_t)


def phase_b4_parity(torch, dev):
    """B4 at B4_CASES, bf16 and f32: each output vector within its bar of
    the plain version run in f32, the whole tensor within TOL of the plain
    version, a second call bit-identical; over the cache with NaN past pos
    the same bits; one launch a call."""
    from paddle_tpu_torch.kernels import attention as at

    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for label, *shape in B4_CASES:
            b, nh, nkv, hd, length, pos = shape
            q, ck, cv, ckn, cvn, pos_t = b4_case(torch, dev, dtype, *shape)
            before = at.launches["decode_attention"]
            out = at.decode_attention(q, ck, cv, pos_t)
            again = at.decode_attention(q, ck, cv, pos_t)
            over_nan = at.decode_attention(q, ckn, cvn, pos_t)
            calls = at.launches["decode_attention"] - before
            ref = at.decode_attention_plain(q, ck, cv, pos_t)
            ref32 = at.decode_attention_plain(q.float(), ck.float(),
                                              cv.float(), pos_t)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = TOL[dname] * max(1.0, ref.float().abs().max().item())
            ratio = flash_row_ratio(torch, out, ref32, TOL[dname])
            splits = (at.decode_splits(at._window_last(pos_t, 1, length))
                      if at.paged_route(dtype) == "cluster" else 0)
            same, nan_same = torch.equal(out, again), torch.equal(out,
                                                                  over_nan)
            log(f"[parity] B4 {dname} {label}: b={b} nh={nh} nkv={nkv} "
                f"hd={hd} len={length} pos={pos}, "
                + (f"{splits} split(s)" if splits else "the shared body")
                + f": max_abs_err {err:.3e} (bar {tol:.3e}), worst row at "
                f"{ratio:.3f} of its bar, a second call "
                f"{'bit-identical' if same else 'DIFFERENT'}, over NaN past "
                f"pos {'the same bits' if nan_same else 'DIFFERENT'}, "
                f"{calls} launches for 3 calls")
            if not (math.isfinite(err) and err <= tol and ratio <= 1.0
                    and same and nan_same and calls == 3):
                raise AssertionError(f"B4 {dname} {label}: {err} (bar {tol}),"
                                     f" row ratio {ratio}, launches {calls}")
            del q, ck, cv, ckn, cvn


def b4_shared(torch, q, ck, cv, pos):
    """A call of B4's shared CUDA-core body in bf16 (the kernel the cluster
    kernel replaced there): its C entry point with splits 0, on fresh
    output; for timing beside the cluster kernel."""
    from paddle_tpu_torch.kernels import _build

    lib = _build.lib("attention")
    b, _, nh, hd = q.shape
    nkv, length = ck.shape[1], ck.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = lib.pt_decode_attention(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, nh, nkv, length, hd, 1, 1, 0,
            1.0 / math.sqrt(hd), stream)
        if rc != 0:
            raise RuntimeError(f"B4's shared body failed: CUDA error {rc}")
    return call


def decode_split_plain(torch, at, q, ck, cv, pos, splits, fault=None):
    """B4 computed the way decode_mma_kernel splits it, in f32: the cache
    [b, nkv, len, hd] is a pool of b pages of len keys, row r's table [r],
    so `paged_split_plain` walks each row's keys [0, min(pos, len - 1)]
    cut over `splits` splits. `fault` plants one of
    PAGED_FAULTS or "tail": the row's last tile read to its end with the
    keys past the row masked out of the softmax but their V rows left in
    P V (p = 0 times what the cache holds there)."""
    bt = torch.arange(q.shape[0], dtype=torch.int32, device=q.device)[:, None]
    return paged_split_plain(torch, at, q, ck, cv, bt, pos, splits,
                             fault=fault)


def planted_b4_faults(torch, at, q, ck, cv, ckn, cvn, pos, splits):
    """B4 outputs with a fault planted, from `decode_split_plain`: [(fault,
    faulty, right)]; the tail fault over the cache with NaN past pos. The
    per-row bar must reject each."""
    right = at.decode_attention_plain(q, ck, cv, pos)
    out = [(name, decode_split_plain(torch, at, q, ck, cv, pos, splits,
                                     fault), right)
           for name, fault in PAGED_FAULTS.items() if fault != "scale page"]
    out.append(("the V rows past a row's pos left in P V (NaN x 0)",
                decode_split_plain(torch, at, q, ckn, cvn, pos, splits,
                                   "tail"), right))
    return out


def phase_b4_bar_teeth(torch, dev, case=0, splits=8):
    """The per-row B4 bar rejects planted faults at the draft's stripe (8
    splits of the 1029-key rows: the short rows leave some empty), each
    beside the whole-tensor rule's ratio; the unplanted split model passes
    against the plain version in f32, over the random cache and over NaN
    past pos."""
    from paddle_tpu_torch.kernels import attention as at

    label, *shape = B4_CASES[case]
    q, ck, cv, ckn, cvn, pos = b4_case(torch, dev, torch.bfloat16, *shape)
    exact = at.decode_attention_plain(q.float(), ck.float(), cv.float(), pos)
    for cache, (k, v) in (("random values", (ck, cv)), ("NaN", (ckn, cvn))):
        model = decode_split_plain(torch, at, q, k, v, pos, splits)
        ok = flash_row_ratio(torch, model, exact, TOL["bfloat16"])
        log(f"[parity] B4 bar at {label}: the split model without a fault, "
            f"{cache} past pos, is at {ok:.3f} of the bar")
        if not ok <= 1.0:
            raise AssertionError(f"B4's split model fails its bar: {ok}")
    for fault, wrong, right in planted_b4_faults(torch, at, q, ck, cv, ckn,
                                                 cvn, pos, splits):
        ratio = flash_row_ratio(torch, wrong, right, TOL["bfloat16"])
        log(f"[parity] B4 bar, planted fault at {label}: {fault} is at "
            f"{ratio:.2f} of the bar")
        if ratio <= 1.0:
            raise AssertionError(f"the B4 bar passes a planted fault: "
                                 f"{fault} at {ratio}")


# B9/B10 parity cases: (label, rows, H, dtype); the first is the 7B leg's
# micro-batch (b4 s2048 over 2 micro-batches: 4096 rows), whose errors go
# into the JSON line
RMS_CASES = (("7B micro-batch", 4096, 4096, "bfloat16"),
             ("h2048 micro-batch", 4096, 2048, "bfloat16"),
             ("decode", 8, 4096, "bfloat16"),
             ("ragged rows", 4097, 4096, "bfloat16"),
             ("f32", 4096, 4096, "float32"),
             ("f32 ragged", 1001, 2048, "float32"))
# B9/B10 against their plain versions, set before the first run on the
# card. y and dx, row by row, within RMS_ROW_TOL of the row's max |plain|:
# bf16 two units in the last place of the row's largest entry (2^-6). y
# rounds twice on both sides, rnd(rnd(x r) w), and an r that differs in its
# last f32 bit (the two sum x^2 in different orders) can move the first
# rounding by a unit, which the multiply by w carries into the second; dx
# rounds once from f32 values that differ by summation order. f32: 1e-5,
# summation order only. r (f32 on both sides) each entry within
# RMS_R_TOL of |plain|: its relative error is half that of the sum of
# squares, ~sqrt(H) f32 roundings (~1e-6 at 4096). dw, summed over the
# rows in f32 in another order and then rounded to w's dtype: max |d| <=
# RMS_DW_TOL of max |plain dw| (bf16: one unit in the last place at the
# largest entry; f32: 1e-5).
RMS_ROW_TOL = {"bfloat16": 2.0**-6, "float32": 1e-5}
RMS_R_TOL = 1e-5
RMS_DW_TOL = {"bfloat16": 2.0**-7, "float32": 1e-5}
RMS_EPS = 1e-6


def rms_case(torch, dev, rows, h, dtype, seed=6):
    """x with rows at scales 10^U(-4, 1) (eps matters in the small ones),
    w ~ N(1, 0.5^2), g ~ N(0, 1), in `dtype` on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 10.0 ** (torch.rand(rows, 1, generator=gen, device=dev) * 5 - 4)
    x = (torch.randn(rows, h, generator=gen, device=dev) * scale).to(dtype)
    w = (torch.randn(h, generator=gen, device=dev) * 0.5 + 1).to(dtype)
    g = torch.randn(rows, h, generator=gen, device=dev).to(dtype)
    return x, w, g


def rms_ratios(torch, got, ref, dname):
    """Each output's worst error over its bar (the kernel passes at <= 1):
    got/ref are {name: tensor} of y, r, dx, dw (any subset)."""
    out = {}
    for name, a in got.items():
        a, b = a.float(), ref[name].float()
        d = (a - b).abs()
        if name in ("y", "dx"):
            bar = RMS_ROW_TOL[dname] * b.abs().amax(-1)
            out[name] = (d.amax(-1) / bar.clamp_min(1e-30)).max().item()
        elif name == "r":
            out[name] = (d / (RMS_R_TOL * b.abs())).max().item()
        else:
            out[name] = (d.max() / (RMS_DW_TOL[dname]
                                    * b.abs().max())).item()
    return out


def rms_dw_split(torch, rn, x, r, g, sms, fault=None):
    """B10's dw the way rms_norm_bwd_kernel sums it, in f32 (before the
    rounding to w's dtype): each row group's rows (`rms_norm.bwd_rows` over
    `bwd_grid`'s blocks and `bwd_plan`'s groups), then the groups of each
    block and the blocks of each cluster in order, then the clusters in
    index order. `fault` plants one of RMS_DW_FAULTS."""
    rows, h = x.shape
    groups = rn.bwd_plan(h, x.element_size())[2]
    blocks, c = rn.bwd_grid(rows, h, x.element_size(), sms)
    terms = g.float() * x.float() * r.float()[:, None]
    part = [terms[a:e].sum(0) for a, e in rn.bwd_rows(rows, blocks, groups)]
    if fault == "group":
        part[0] = torch.zeros_like(part[0])
    per = c * groups                      # row groups a cluster
    clusters = [sum(part[k * per:(k + 1) * per])
                for k in range(blocks // c)]
    if fault == "twice":
        clusters[0] = 2 * clusters[0]
    if fault == "skip":
        clusters[-1] = torch.zeros_like(clusters[-1])
    return sum(clusters)


# planted faults of B10's dw sum (`rms_dw_split`)
RMS_DW_FAULTS = {"one row group's rows left out of dw": "group",
                 "one cluster's dw partial counted twice": "twice",
                 "one cluster's dw partial left out": "skip"}


def planted_rms_faults(torch, rn, x, w, g, sms):
    """B9/B10 outputs with a fault planted, built from the plain versions
    and B10's dw split (`rms_dw_split`): [(fault, {output: faulty},
    {output: right})]. The bars must reject each on at least one
    output."""
    h = x.shape[1]
    y, r = rn.rms_norm_fwd_plain(x, w, RMS_EPS)
    dx, dw = rn.rms_norm_bwd_plain(x, w, r, g)
    x32 = x.float()

    def fwd_with(rr):
        return (x32 * rr[:, None]).to(x.dtype) * w

    y_e, r_e = rn.rms_norm_fwd_plain(x, w, 0.0)
    r_h = torch.rsqrt((x32 * x32).sum(-1) / (h - 1) + RMS_EPS)
    r_o = r.roll(1)
    right = {"y": y, "r": r, "dx": dx, "dw": dw}
    return [("eps dropped", {"y": y_e, "r": r_e}, right),
            ("the mean taken over H - 1", {"y": fwd_with(r_h), "r": r_h},
             right),
            ("r from another row", {"y": fwd_with(r_o), "r": r_o,
                                    "dx": rn.rms_norm_bwd_plain(
                                        x, w, r_o, g)[0]}, right)] + [
        (name, {"dw": rms_dw_split(torch, rn, x, r, g, sms, fault).to(
            w.dtype)}, right) for name, fault in RMS_DW_FAULTS.items()]


def phase_rms_parity(torch, dev):
    """B9 and B10 against their plain versions on the card, each output
    within its bar (`rms_ratios`); then planted faults the bars must
    reject, at the 7B case and the f32 case. Returns the first case's max
    |error| by launch key (y for B9, dx and dw for B10)."""
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import rms_norm as rn

    main_err = {}
    for i, (label, rows, h, dname) in enumerate(RMS_CASES):
        x, w, g = rms_case(torch, dev, rows, h, getattr(torch, dname))
        y, r = rn.rms_norm_fwd(x, w, RMS_EPS)
        ry, rr = rn.rms_norm_fwd_plain(x, w, RMS_EPS)
        # B10 from the plain forward's r, so that it is held to its plain
        # version on the same inputs
        before = rn.launches["rms_norm_bwd"]
        dx, dw = rn.rms_norm_bwd(x, w, rr, g)
        dx2, dw2 = rn.rms_norm_bwd(x, w, rr, g)
        calls = rn.launches["rms_norm_bwd"] - before
        rdx, rdw = rn.rms_norm_bwd_plain(x, w, rr, g)
        torch.cuda.synchronize()
        got = {"y": y, "r": r, "dx": dx, "dw": dw}
        ref = {"y": ry, "r": rr, "dx": rdx, "dw": rdw}
        ratios = rms_ratios(torch, got, ref, dname)
        errs = {k: (got[k].float() - ref[k].float()).abs().max().item()
                for k in got}
        same = torch.equal(dx, dx2) and torch.equal(dw, dw2)
        log(f"[parity] rms_norm {label} [{rows}, {h}] {dname}: " + ", ".join(
            f"{k} max_abs_err {errs[k]:.3e} at {ratios[k]:.3f} of its bar"
            for k in got) + f"; B10 grid (blocks, cluster) "
            f"{rn.bwd_grid(rows, h, x.element_size(), qm._sms(dev))}, "
            f"a second call {'bit-identical' if same else 'DIFFERENT'} (dx, "
            f"dw), {calls} launches for 2 calls")
        if not all(math.isfinite(v) and v <= 1.0 for v in ratios.values()) \
                or not same or calls != 2:
            raise AssertionError(f"rms_norm {label}: a kernel disagrees with "
                                 f"its plain version: {ratios}, or B10 is "
                                 f"not reproducible ({same}) or launched "
                                 f"{calls} times for 2 calls")
        if i == 0:
            main_err = {"rms_norm_fwd": errs["y"],
                        "rms_norm_bwd": max(errs["dx"], errs["dw"])}
        if label in ("7B micro-batch", "f32"):
            sms = qm._sms(dev)
            split = rms_dw_split(torch, rn, x, rr, g, sms).to(w.dtype)
            ok = rms_ratios(torch, {"dw": split}, {"dw": rdw}, dname)["dw"]
            log(f"[parity] rms_norm bar at {label}: B10's dw split without a "
                f"fault is at {ok:.3f} of its bar")
            if not ok <= 1.0:
                raise AssertionError(f"B10's dw split fails its bar: {ok}")
            for fault, wrong, right in planted_rms_faults(torch, rn, x, w, g,
                                                          sms):
                bad = rms_ratios(torch, wrong, right, dname)
                log(f"[parity] rms_norm bar, planted fault at {label}: "
                    f"{fault}: " + ", ".join(f"{k} at {v:.2f} of its bar"
                                             for k, v in bad.items()))
                if not max(bad.values()) > 1.0:
                    raise AssertionError(f"the rms_norm bars pass a planted "
                                         f"fault: {fault} at {bad}")
        del x, w, g, y, r, ry, rr, dx, dw, dx2, dw2, rdx, rdw, got, ref
        torch.cuda.empty_cache()
    return main_err


# B1-B3 parity cases: (label, b, sq, sk, h, hk, d, causal, dtype); the first
# is the 7B leg's micro-batch, whose errors go into the JSON line
FLASH_CASES = (
    ("bf16 causal b2 h32 s2048 d128", 2, 2048, 2048, 32, 32, 128, True,
     "bfloat16"),
    ("bf16 causal GQA nh32/nkv8 s1024", 1, 1024, 1024, 32, 8, 128, True,
     "bfloat16"),
    ("bf16 non-causal h16 s1024", 1, 1024, 1024, 16, 16, 128, False,
     "bfloat16"),
    ("bf16 causal cross-length sq384/sk1024", 2, 384, 1024, 8, 8, 128, True,
     "bfloat16"),
    ("bf16 causal ragged s1000 GQA 8/4", 1, 1000, 1000, 8, 4, 128, True,
     "bfloat16"),
    ("bf16 causal sq1000 > sk300 (fully masked rows)", 1, 1000, 300, 8, 8,
     128, True, "bfloat16"),
    ("bf16 causal hd64 ragged s777 GQA 4/2", 2, 777, 777, 4, 2, 64, True,
     "bfloat16"),
    # one row past a 128-row Q tile, one key short of a 128-key tile
    ("bf16 causal sq129/sk127 GQA 4/2 (rows 0-1 see no key)", 2, 129, 127,
     4, 2, 128, True, "bfloat16"),
    ("bf16 non-causal hd64 sq129/sk127", 1, 129, 127, 4, 4, 64, False,
     "bfloat16"),
    # the backward's tile edges: Sq and Sk off the 128- and 64-row tiles, a
    # GQA group of 8, and rows past Sk without the causal mask
    ("bf16 causal sq192/sk320 GQA 8/2", 1, 192, 320, 8, 2, 128, True,
     "bfloat16"),
    ("bf16 causal hd64 sq65/sk129", 1, 65, 129, 4, 4, 64, True, "bfloat16"),
    ("bf16 causal s256 GQA 8/1", 1, 256, 256, 8, 1, 128, True, "bfloat16"),
    ("bf16 non-causal sq300 > sk200 GQA 8/4", 1, 300, 200, 8, 4, 128, False,
     "bfloat16"),
    ("f32 causal s512 d128 GQA 4/2", 1, 512, 512, 4, 2, 128, True,
     "float32"),
    ("f32 non-causal sq300/sk200 d64", 1, 300, 200, 4, 4, 64, False,
     "float32"),
    ("f32 causal sq300 > sk100 d128 (fully masked rows)", 1, 300, 100, 4, 2,
     128, True, "float32"),
)


def flash_case(torch, dev, b, sq, sk, h, hk, d, dtype, seed=5):
    """q, k, v, do ~ N(0, 1) in `dtype` on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    return rnd(b, sq, h, d), rnd(b, sk, hk, d), rnd(b, sk, hk, d), \
        rnd(b, sq, h, d)


# B1-B3 against their plain versions, vector by vector: out and dq for each
# (query, head), dk and dv for each (key, kv head), each within TOL of that
# vector's largest |plain| entry (2 bf16 units in its last place). One bar
# for the whole tensor would be set by the causal extremes (query 0 sees one
# key, so its out is a row of v) and would pass a kernel that is wrong for
# the queries that average hundreds of keys. No bar is below FLASH_FLOOR *
# the tensor's max |plain| (what summation order alone leaves in f32, so the
# f32 cases keep the whole-tensor rule): a vector whose plain values are ~0
# by cancellation (dq of query 0 under causal attention: its one key gives
# dS = P(dP - delta) = 0) differs by f32 rounding only. lse is f32 on both
# sides: each entry within FLASH_LSE_TOL * max(1, |plain|).
FLASH_FLOOR = 1e-5
FLASH_LSE_TOL = 1e-5


def flash_row_ratio(torch, got, ref, tol):
    """The worst vector's max |got - ref| over its bar, tol * its max |ref|
    (over the last dim) or FLASH_FLOOR * max |ref|, the larger; the kernel
    passes at <= 1. Where the plain version is 0 throughout (no query sees
    a key), the kernel's must be 0."""
    d = (got.float() - ref.float()).abs().amax(-1)
    top = ref.float().abs().amax(-1)
    bar = (tol * top).clamp_min(FLASH_FLOOR * top.max().item())
    return (d / bar.clamp_min(1e-30)).max().item()


def flash_lse_ratio(torch, got, ref):
    bar = FLASH_LSE_TOL * ref.float().abs().clamp_min(1.0)
    return ((got.float() - ref.float()).abs() / bar).max().item()


def planted_flash_faults(torch, fa, q, k, v, do, causal, tile=64):
    """B1-B3 outputs with a fault planted, built from the plain versions:
    [(fault, output name, faulty, right)]. The bar must reject each."""
    g = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    out, lse = fa.flash_fwd_plain(q, k, v, causal)
    dq, dk, _ = fa.flash_bwd_plain(q, k, v, out, lse, do, causal)
    v_tail0 = v.clone()
    v_tail0[:, -tile:] = 0
    faults = [
        ("sm_scale 1% high", "out",
         fa.flash_fwd_plain(q, k, v, causal, scale * 1.01)[0], out),
        ("the last key tile's V read as zeros", "out",
         fa.flash_fwd_plain(q, k, v_tail0, causal)[0], out),
        ("delta left out of dS", "dq",
         fa.flash_bwd_dq_plain(q, k, v, do, lse, torch.zeros_like(lse),
                               causal), dq)]
    if g > 1:
        kr, vr = (t.repeat_interleave(g, dim=2) for t in (k, v))
        faults.append(("dk of one query head a group (no GQA sum)", "dk",
                       fa.flash_bwd_plain(q, kr, vr, out, lse, do,
                                          causal)[1][:, :, ::g], dk))
    return faults


def phase_flash_bar_teeth(torch, dev, case=1):
    """The B1-B3 bar rejects planted faults at a parity shape (the GQA case
    by default), each beside the ratio the whole-tensor rule (TOL * max(1,
    max |plain|)) would give it."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    label, b, sq, sk, h, hk, d, causal, dname = FLASH_CASES[case]
    q, k, v, do = flash_case(torch, dev, b, sq, sk, h, hk, d,
                             getattr(torch, dname))
    for fault, name, wrong, right in planted_flash_faults(torch, fa, q, k, v,
                                                          do, causal):
        ratio = flash_row_ratio(torch, wrong, right, TOL[dname])
        whole = ((wrong.float() - right.float()).abs().max()
                 / (TOL[dname] * right.float().abs().max().clamp_min(1.0))
                 ).item()
        log(f"[parity] flash bar, planted fault at {label}: {fault} ({name})"
            f" is at {ratio:.2f} of the bar (the whole-tensor rule: "
            f"{whole:.2f})")
        if not ratio > 1.0:
            raise AssertionError(f"the flash bar passes a planted fault: "
                                 f"{fault} at {ratio}")
    torch.cuda.empty_cache()


def phase_flash_parity(torch, dev):
    """B1, and B2 + B3 through `flash_bwd`, against their plain versions on
    the card (`flash_row_ratio`); returns the first case's max |error| by
    launch key."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    main_err = {}
    for i, (label, b, sq, sk, h, hk, d, causal, dname) in enumerate(
            FLASH_CASES):
        dtype = getattr(torch, dname)
        q, k, v, do = flash_case(torch, dev, b, sq, sk, h, hk, d, dtype)
        out, lse = fa.flash_fwd(q, k, v, causal)
        ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal)
        # the backward from the plain forward's outputs, so that B2/B3 are
        # held to their plain versions on the same inputs
        dq, dk, dv = fa.flash_bwd(q, k, v, ref_out, ref_lse, do, causal)
        rdq, rdk, rdv = fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do,
                                           causal)
        torch.cuda.synchronize()
        masked = ref_lse <= -1e29
        lse_ok = bool(((lse <= -1e29) == masked).all().item())
        errs = {}
        for name, got, ref in (("out", out, ref_out),
                               ("lse", torch.where(masked, 0.0, lse),
                                torch.where(masked, 0.0, ref_lse)),
                               ("dq", dq, rdq), ("dk", dk, rdk),
                               ("dv", dv, rdv)):
            err = (got.float() - ref.float()).abs().max().item()
            ratio = (flash_lse_ratio(torch, got, ref) if name == "lse"
                     else flash_row_ratio(torch, got, ref, TOL[dname]))
            errs[name] = err
            log(f"[parity] flash {label}: {name} max_abs_err {err:.3e}, "
                f"worst {'entry' if name == 'lse' else 'row'} at "
                f"{ratio:.3f} of its bar")
            if not (math.isfinite(ratio) and ratio <= 1.0):
                raise AssertionError(f"flash {label}: {name} disagrees with "
                                     f"the plain version (worst at {ratio} "
                                     "of its bar)")
        if not lse_ok:
            raise AssertionError(f"flash {label}: the fully masked rows "
                                 "differ")
        if i == 0:
            main_err = {"flash_fwd": errs["out"], "flash_bwd_dq": errs["dq"],
                        "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
        del q, k, v, do, out, lse, ref_out, ref_lse, dq, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return main_err


# ---------------------------------------------------------------------------
# training: the engine's step at bench.py's training legs
# ---------------------------------------------------------------------------


# bench.py::_candidate_configs (:150) as `LlamaConfig` keywords, and how
# `_bench` (:95) drives each: (config, batch, seq, micro-batches)
H4096 = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
             num_hidden_layers=4, num_attention_heads=32,
             max_position_embeddings=2048)
H2048 = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
             num_hidden_layers=16, num_attention_heads=16,
             max_position_embeddings=2048)
TRAIN_LEGS = {"train": (H4096, 4, 2048, 2),          # bench.py:186
              "train-h2048": (H2048, 8, 1024, 2)}    # bench.py:169
# train-check bars, f32 weights (set before the first run): both sides
# compute in f32 with TF32 off and differ in the order of their sums (B1-B3
# stream online softmax, the fused CE sums chunk by chunk)
TRAIN_CHECK_BARS = {"loss_rel": 1e-5, "grad_rel": 1e-3}
# its bf16 leg: the same weights rounded to bf16, through B1-B3 and through
# the plain bf16 attention (use_flash=False), each against the f32
# reference. Both legs round the same weights and activations; the kernels
# may not leave the worst grad leaf further from the reference than
# BF16_VS_PLAIN times the plain leg's, and neither leg may pass the bars
# (the loss bar set from a first reading: rel 1.2e-4 through B1-B3, 6.3e-5
# through the plain attention; worst grad leaves 2.4e-2 and 3.2e-2).
TRAIN_CHECK_BF16_BARS = {"loss_rel": 1e-3, "grad_rel": 5e-2}
BF16_VS_PLAIN = 1.5
PEAK_SEEN = []   # device memory peaks read before a phase resets the peak


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{prefix}/{k}")]
    return [(prefix, tree)]


def reference_train_loss(torch, params, ids, labels, args):
    """Mean next-token CE of one sequence (ids, labels [1, T]) in f32,
    sharing no code with the port: norms, RoPE and the SwiGLU written out,
    materialized causal attention (`_attention`), the full [T, vocab]
    logits and an unfused CE, differentiated by plain autograd."""
    import torch.nn.functional as F

    T, hd = ids.shape[1], args.head_dim
    f32, dev = torch.float32, ids.device
    inv = 1.0 / (args.rope_theta ** (torch.arange(0, hd, 2, device=dev,
                                                  dtype=f32) / hd))
    ang = torch.outer(torch.arange(T, device=dev, dtype=f32), inv)
    cos = torch.cat([ang, ang], -1).cos()[:, None]
    sin = torch.cat([ang, ang], -1).sin()[:, None]

    def norm(x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True)
                               + args.rms_eps) * w

    def rope(x):
        x1, x2 = x.chunk(2, dim=-1)
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    lay = params["layers"]
    h = params["embedding"][ids[0]]
    for i in range(args.num_layers):
        x = norm(h, lay["ln1"][i])
        q = (x @ lay["wq"][i]).view(T, args.num_heads, hd)
        k = (x @ lay["wk"][i]).view(T, args.num_kv_heads, hd)
        v = (x @ lay["wv"][i]).view(T, args.num_kv_heads, hd)
        h = h + _attention(torch, rope(q), rope(k), v).reshape(T, -1) \
            @ lay["wo"][i]
        x = norm(h, lay["ln2"][i])
        h = h + (F.silu(x @ lay["w_gate"][i]) * (x @ lay["w_up"][i])) \
            @ lay["w_down"][i]
    logits = norm(h, params["final_norm"]) @ params["lm_head"]
    true = logits.gather(-1, labels[0][:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - true).mean()


def _worst_grad(params, ref_params):
    """(leaf path, ||grad - ref grad|| / ||ref grad||) of the worst leaf."""
    worst = ("", 0.0)
    for (path, p), (_, r) in zip(_leaves(params), _leaves(ref_params)):
        rel = ((p.grad.float() - r.grad).norm() / r.grad.norm()).item()
        if not math.isfinite(rel) or rel > worst[1]:
            worst = (path, rel)
    return worst


def _bf16_copy(torch, tree):
    if isinstance(tree, dict):
        return {k: _bf16_copy(torch, v) for k, v in tree.items()}
    return tree.detach().to(torch.bfloat16).requires_grad_(True)


def phase_train_check(torch, dev, seq=1024, loss_chunk=128):
    """The port's loss and grad tree (B1-B3, the fused CE) against
    `reference_train_loss` at Llama-2-7B width, 2 layers: f32 weights (the
    f32 kernels), then the same weights in bf16 through the bf16 kernels
    the training legs run, beside the plain bf16 attention."""
    import numpy as np
    from paddle_tpu_torch.models import LLAMA2_7B, init_params
    from paddle_tpu_torch.models import llama_functional as lf

    args = LLAMA2_7B._replace(num_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(args, gen, device=dev, dtype=torch.float32)
    ref_params = {"embedding": params["embedding"].clone(),
                  "layers": {k: v.clone()
                             for k, v in params["layers"].items()},
                  "final_norm": params["final_norm"].clone(),
                  "lm_head": params["lm_head"].clone()}
    for tree in (params, ref_params):
        for _, t in _leaves(tree):
            t.requires_grad_(True)
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(
        0, args.vocab_size, (1, seq)).astype(np.int64)).to(dev)
        for _ in range(2))
    ref = reference_train_loss(torch, ref_params, ids, labels, args)
    ref.backward()
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    bars = TRAIN_CHECK_BARS
    readings = {}
    for leg, tree, use_flash in (("f32", params, True),
                                 ("bf16", _bf16_copy(torch, ref_params), True),
                                 ("bf16 plain attention",
                                  _bf16_copy(torch, ref_params), False)):
        reset_launches()
        loss = lf.forward_and_loss(tree, ids, labels,
                                   args._replace(use_flash=use_flash),
                                   remat=False, loss_chunk=loss_chunk)
        loss.backward()
        torch.cuda.synchronize(dev)
        launches = {k: launch_counts()[k] for k in flash + NORMS}
        loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
        worst = _worst_grad(tree, ref_params)
        readings[leg] = (loss_rel, worst[1])
        log(f"[train-check] Llama-2-7B width, 2 layers, {leg}, s {seq}, "
            f"loss_chunk {loss_chunk}: loss {loss.item():.6f} vs the f32 "
            f"reference {ref.item():.6f}, rel {loss_rel:.3e}; worst grad "
            f"leaf {worst[0]} ||d||/||ref|| {worst[1]:.3e}; launches "
            f"{launches}")
        want = dict.fromkeys(flash, args.num_layers if use_flash else 0)
        want.update(dict.fromkeys(NORMS, 2 * args.num_layers + 1))
        if not (math.isfinite(loss_rel) and math.isfinite(worst[1])
                and launches == want):
            raise AssertionError(f"train-check {leg}: loss rel {loss_rel}, "
                                 f"grad {worst}, launches {launches}")
        del tree, loss
    f32, bf, plain = (readings[k] for k in ("f32", "bf16",
                                            "bf16 plain attention"))
    bf_bars = TRAIN_CHECK_BF16_BARS
    grad_bar = min(bf_bars["grad_rel"], BF16_VS_PLAIN * plain[1])
    log(f"[train-check] bars: f32 loss rel {bars['loss_rel']}, grad "
        f"{bars['grad_rel']}; bf16 loss rel {bf_bars['loss_rel']}, grad "
        f"{bf_bars['grad_rel']}, and through B1-B3 grad {grad_bar:.3e} "
        f"({BF16_VS_PLAIN}x the plain attention's)")
    if not (f32[0] <= bars["loss_rel"] and f32[1] <= bars["grad_rel"]):
        raise AssertionError(f"train-check f32: {f32} over {bars}")
    if not (max(bf[0], plain[0]) <= bf_bars["loss_rel"]
            and plain[1] <= bf_bars["grad_rel"] and bf[1] <= grad_bar):
        raise AssertionError(f"train-check bf16: B1-B3 {bf}, the plain "
                             f"attention {plain}, bars {bf_bars}, grad "
                             f"{grad_bar}")


# the eager phase: Llama-2-7B width, 2 layers, b 1, s 2048, causal, written
# against the port's eager surface; held to `forward_and_loss` on the same
# weights. f32 bars are train-check's; bf16 holds the loss only.
EAGER_LEG = dict(layers=2, batch=1, seq=2048)
EAGER_BARS = {"loss_rel": 1e-5, "grad_rel": 1e-3}
EAGER_BF16_LOSS_REL = 1e-3


def eager_llama_loss(P, params, ids, labels, args):
    """Mean next-token CE of a Llama over the eager surface of module `P`
    (`paddle_tpu_torch`, or `paddle_tpu` in the CPU tests): embedding by
    `index_select`, RMSNorm from `mean` and `rsqrt` (normalised in f32,
    cast back, scaled by w), RoPE from `split` / `concat` (in f32), causal
    `nn.functional.flash_attention`, SwiGLU from `sigmoid`, the CE from
    `logsumexp` and `take_along_axis` over f32 logits. `params` is
    `llama_functional`'s tree of P Tensors (layer leaves stacked on L),
    ids / labels [B, T] int Tensors."""
    B, T = ids.shape
    nh, nkv, hd = args.num_heads, args.num_kv_heads, args.head_dim
    inv = 1.0 / (args.rope_theta ** (P.arange(0, hd, 2, dtype="float32")
                                     / hd))
    ang = P.unsqueeze(P.arange(T, dtype="float32"), 1) * P.unsqueeze(inv, 0)
    ang = P.reshape(P.concat([ang, ang], axis=-1), [1, T, 1, hd])
    cos, sin = P.cos(ang), P.sin(ang)

    def norm(x, w):
        xf = P.cast(x, "float32")
        r = P.rsqrt(P.mean(xf * xf, axis=-1, keepdim=True) + args.rms_eps)
        return P.cast(xf * r, x.dtype) * w

    def rope(x):
        xf = P.cast(x, "float32")
        x1, x2 = P.split(xf, 2, axis=-1)
        return P.cast(xf * cos + P.concat([-x2, x1], axis=-1) * sin,
                      x.dtype)

    lay = params["layers"]
    h = P.reshape(P.index_select(params["embedding"], P.reshape(ids, [-1])),
                  [B, T, -1])
    for i in range(args.num_layers):
        x = norm(h, lay["ln1"][i])
        q = P.reshape(P.matmul(x, lay["wq"][i]), [B, T, nh, hd])
        k = P.reshape(P.matmul(x, lay["wk"][i]), [B, T, nkv, hd])
        v = P.reshape(P.matmul(x, lay["wv"][i]), [B, T, nkv, hd])
        o, _ = P.nn.functional.flash_attention(rope(q), rope(k), v,
                                               causal=True)
        h = h + P.matmul(P.reshape(o, [B, T, nh * hd]), lay["wo"][i])
        x = norm(h, lay["ln2"][i])
        g = P.matmul(x, lay["w_gate"][i])
        h = h + P.matmul(g * P.sigmoid(g) * P.matmul(x, lay["w_up"][i]),
                         lay["w_down"][i])
    logits = P.cast(P.matmul(norm(h, params["final_norm"]),
                             params["lm_head"]), "float32")
    true = P.take_along_axis(logits, P.unsqueeze(labels, -1), axis=-1)
    return P.mean(P.logsumexp(logits, axis=-1) - P.squeeze(true, axis=-1))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _ops_dispatched(torch, fn):
    """(result of fn(), the aten ops it dispatched), counted by a
    TorchDispatchMode (every op torch runs for the call, forward and
    backward, below the Python surface)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def _busy_share(torch, dev, fn, n_steps=2, top=8):
    """(wall ms a step, device-busy ms a step, {group: busy ms a step},
    [(kernel, ms a step, launches a step)] of the `top` kernels by device
    time) of fn() under torch.profiler, or None when the profiler sees no
    device activity. The groups: matrix products (MATMUL_NAMES), B1-B3
    (names holding `flash_`), and the rest (norms, RoPE, casts, SwiGLU, CE, embedding)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if str(e.device_type).endswith("CUDA")
            and e.time_range.end > e.time_range.start]
    if not kern:
        return None
    per_name, groups = {}, {"matmul": 0.0, "B1-B3": 0.0, "rest": 0.0}
    for e in kern:
        us = e.time_range.end - e.time_range.start
        t, n = per_name.get(e.name, (0.0, 0))
        per_name[e.name] = (t + us, n + 1)
        g = ("B1-B3" if "flash_" in e.name else "matmul"
             if any(f in e.name for f in MATMUL_NAMES) else "rest")
        groups[g] += us
    busy = sum(groups.values())
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return (wall_us / n_steps / 1e3, busy / n_steps / 1e3,
            {g: us / n_steps / 1e3 for g, us in groups.items()},
            [(name, us / n_steps / 1e3, n / n_steps)
             for name, (us, n) in ranked])


def phase_eager(torch, dev, warmup=2, steps=8):
    """The eager surface on the card: a to_tensor with no place lands on
    cuda:0; `eager_llama_loss` at Llama-2-7B width (2 layers, b 1, s 2048)
    against `forward_and_loss(remat=False)` on the same weights, f32 (loss
    and every grad leaf) and bf16 (loss); B1 launched >= L times in the
    forward, B2 and B3 >= L times in the backward, from the eager path.
    Then, in bf16, the eager step's ms (2 warm-up, `steps` synchronised),
    its aten ops and device-busy share, beside the functional path's.
    Returns the launch counts of the eager runs."""
    import numpy as np
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import device as device_mod
    from paddle_tpu_torch.models import LLAMA2_7B, init_params
    from paddle_tpu_torch.models import llama_functional as lf

    device_mod._current = None   # the default: no set_device
    placed = paddle.to_tensor([1.0, 2.0]).place
    log(f"[eager] paddle.to_tensor with no place and no set_device lands on "
        f"{placed}")
    if placed != torch.device("cuda", 0):
        raise AssertionError(f"eager: to_tensor landed on {placed}")
    args = LLAMA2_7B._replace(num_layers=EAGER_LEG["layers"])
    B, T = EAGER_LEG["batch"], EAGER_LEG["seq"]
    gen = torch.Generator(device=dev).manual_seed(0)
    base = init_params(args, gen, device=dev, dtype=torch.float32)
    rng = np.random.default_rng(0)
    ids, labels = (torch.from_numpy(rng.integers(
        0, args.vocab_size, (B, T)).astype(np.int64)).to(dev)
        for _ in range(2))
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    total = {k: 0 for k in launch_counts()}
    readings = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        ref_tree = _tree_map(lambda t: t.detach().to(dtype)
                             .requires_grad_(True), base)
        ref = lf.forward_and_loss(ref_tree, ids, labels, args, remat=False)
        ref.backward()
        tree = _tree_map(lambda t: paddle.Tensor(t.detach().to(dtype),
                                                 stop_gradient=False), base)
        torch.cuda.synchronize(dev)
        reset_launches()
        loss = eager_llama_loss(paddle, tree, paddle.Tensor(ids),
                                paddle.Tensor(labels), args)
        torch.cuda.synchronize(dev)
        fwd = dict(launch_counts())
        loss.backward()
        torch.cuda.synchronize(dev)
        after = launch_counts()
        _add(total, after)
        bwd = {k: after[k] - fwd[k] for k in flash}
        loss_rel = abs(loss.item() - ref.item()) / abs(ref.item())
        worst = ("", 0.0)
        for (path, t), (_, r) in zip(_leaves(tree), _leaves(ref_tree)):
            rel = ((t._data.grad.float() - r.grad.float()).norm()
                   / r.grad.float().norm()).item()
            if not math.isfinite(rel) or rel > worst[1]:
                worst = (path, rel)
        readings[dname] = (loss_rel, worst)
        log(f"[eager] Llama-2-7B width, {args.num_layers} layers, b {B} s "
            f"{T}, {dname}: eager loss {loss.item():.6f} vs forward_and_loss "
            f"{ref.item():.6f}, rel {loss_rel:.3e}; worst grad leaf "
            f"{worst[0]} ||d||/||ref|| {worst[1]:.3e}; B1 launches in the "
            f"forward {fwd['flash_fwd']}, B2/B3 in the backward "
            f"{bwd['flash_bwd_dq']}/{bwd['flash_bwd_dkv']}")
        L = args.num_layers
        if fwd["flash_fwd"] < L or bwd["flash_bwd_dq"] < L or \
                bwd["flash_bwd_dkv"] < L or fwd["flash_bwd_dq"]:
            raise AssertionError(f"eager {dname}: launches forward {fwd}, "
                                 f"backward {bwd}")
        del ref_tree, ref, loss
        if dtype == torch.float32:
            del tree
    f32_rel, f32_worst = readings["float32"]
    bf_rel, bf_worst = readings["bfloat16"]
    log(f"[eager] bars: f32 loss rel {EAGER_BARS['loss_rel']}, worst grad "
        f"leaf {EAGER_BARS['grad_rel']}; bf16 loss rel "
        f"{EAGER_BF16_LOSS_REL} (its worst leaf {bf_worst[0]} "
        f"{bf_worst[1]:.3e}, recorded)")
    if not (f32_rel <= EAGER_BARS["loss_rel"]
            and f32_worst[1] <= EAGER_BARS["grad_rel"]
            and bf_rel <= EAGER_BF16_LOSS_REL):
        raise AssertionError(f"eager: f32 {readings['float32']}, bf16 "
                             f"{readings['bfloat16']}")

    # speed, bf16: the eager step beside the functional one, same weights
    ref_tree = _tree_map(lambda t: t.detach().requires_grad_(True),
                         _tree_map(lambda p: p._data, tree))
    pids, plabels = paddle.Tensor(ids), paddle.Tensor(labels)

    def eager_step():
        for _, t in _leaves(tree):
            t.clear_grad()
        eager_llama_loss(paddle, tree, pids, plabels, args).backward()

    def functional_step():
        for _, t in _leaves(ref_tree):
            t.grad = None
        lf.forward_and_loss(ref_tree, ids, labels, args,
                            remat=False).backward()

    rows = {}
    for label, step in (("eager", eager_step),
                        ("functional", functional_step)):
        for _ in range(warmup):
            step()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3 / steps
        _, n_ops = _ops_dispatched(torch, step)
        prof = _busy_share(torch, dev, step)
        rows[label] = (ms, n_ops, prof)
        busy = ("busy not measured: the profiler saw no device activity"
                if prof is None else
                f"profiled wall {prof[0]:.2f} ms, device busy {prof[1]:.2f} "
                f"ms ({prof[1] / prof[0]:.1%}): " + ", ".join(
                    f"{g} {v:.2f} ms" for g, v in prof[2].items()))
        log(f"[eager] bf16 {label} forward + backward: {ms:.2f} ms a step "
            f"(mean of {steps} synchronised after {warmup} warm-up); "
            f"{n_ops} aten ops dispatched a step; {busy}")
        if prof is not None:
            for name, kms, n in prof[3]:
                log(f"[eager]   {label} kernel {kms:.3f} ms in {n:g} "
                    f"launches a step: {name[:110]}")
    log(f"[eager] eager / functional step time "
        f"{rows['eager'][0] / rows['functional'][0]:.3f}x, aten ops "
        f"{rows['eager'][1]} vs {rows['functional'][1]}")
    device_mod._current = None
    return total


MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
NORMS = ("rms_norm_fwd", "rms_norm_bwd")
TRAIN_RANGES = ("fused_ce", "adamw_update")


def phase_train_profile(torch, dev, eng, params, opt, ids, labels, label,
                        n_steps=2):
    """Where a step's device time goes: n_steps under torch.profiler. The
    port runs the fused CE and the AdamW update inside the named ranges
    TRAIN_RANGES; a kernel belongs to a range when it runs inside the
    range's span on the device. Kernels split into attention (B1-B3),
    matrix products outside the CE (cuBLAS), the fused CE (its matmuls
    included), the optimizer, and the rest (norms, RoPE, SwiGLU, embedding,
    grad accumulation and casts). Reports "not measured" when the profiler
    sees no device activity, and fails when it sees kernels but not both
    ranges."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            loss, params, opt = eng.train_batch(params, opt, ids, labels)
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    on_card = [e for e in prof.events()
               if str(e.device_type).endswith("CUDA")]
    spans = [e for e in on_card if e.name in TRAIN_RANGES]
    kern = [e for e in on_card if e.name not in TRAIN_RANGES
            and e.time_range.end > e.time_range.start]
    if not kern:
        log(f"[{label}] device time not measured: the profiler saw no "
            "device activity")
        return None
    missing = set(TRAIN_RANGES) - {r.name for r in spans}
    if missing:
        raise AssertionError(f"{label}: the profiler saw no device span of "
                             f"the port's ranges {sorted(missing)}")

    def us(kernels):
        return sum(e.time_range.end - e.time_range.start for e in kernels)

    def within(name):
        rs = [(r.time_range.start, r.time_range.end) for r in spans
              if r.name == name]
        return [k for k in kern if any(a <= k.time_range.start
                                       and k.time_range.end <= b
                                       for a, b in rs)]

    def is_mm(name):
        return any(f in name for f in MATMUL_NAMES)

    busy = us(kern)
    ce_k, opt_k = within("fused_ce"), within("adamw_update")
    ce_ids = {id(k) for k in ce_k}
    shares = {"matmul": us(k for k in kern
                           if is_mm(k.name) and id(k) not in ce_ids),
              "attention B1-B3": us(k for k in kern if "flash_" in k.name),
              "norms B9/B10": us(k for k in kern if "rms_norm_" in k.name),
              "fused CE": us(ce_k), "optimizer": us(opt_k)}
    shares["other"] = busy - sum(shares.values())
    per = n_steps * 1e3
    log(f"[{label}] {n_steps} profiled steps: wall {wall_us / per:.1f} ms a "
        f"step, device busy {busy / per:.1f} ms ({busy / wall_us:.1%}); of "
        "device time: " + ", ".join(
            f"{k} {v / busy:.1%} ({v / per:.1f} ms)"
            for k, v in shares.items())
        + f"; the fused CE's matmuls {us(k for k in ce_k if is_mm(k.name)) / busy:.1%}")
    top = [e for e in prof.key_averages()
           if str(e.device_type).endswith("CUDA")
           and e.key not in TRAIN_RANGES and e.self_device_time_total > 0]
    for e in sorted(top, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{label}]   {e.self_device_time_total / busy:6.1%} "
            f"{e.count / n_steps:5.0f}/step  {e.key[:90]}")
    for kid in ("B1", "B2", "B3", "B9", "B10"):
        frags = PROFILE_NAMES[kid]
        t = us(k for k in kern if any(f in k.name for f in frags))
        log(f"[{label}]   {kid}: {t / busy:.1%} of device time, "
            f"{t / per:.3f} ms a step")
    return {"wall_ms": wall_us / per, "busy_ms": busy / per}


def phase_train(torch, dev, name, label, warmup=2, steps=8):
    """bench.py's `_bench` on the port: `HybridParallelEngine` at one
    training leg, bf16 params from seed 0, numpy ids/labels from seed 0;
    2 warm-up and `steps` timed steps ending in a synchronise. Returns the
    launch counts of the timed steps."""
    import types

    import numpy as np
    from paddle_tpu_torch.distributed import HybridParallelEngine
    from paddle_tpu_torch.observability.hardware import llama_flops_per_token

    cfg_kw, batch, seq, mb = TRAIN_LEGS[label]
    torch.cuda.empty_cache()
    PEAK_SEEN.append(torch.cuda.max_memory_allocated(dev))
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = types.SimpleNamespace(**cfg_kw)    # the reference's names
    eng = HybridParallelEngine(cfg, dp=1, pp=1, mp=1, micro_batches=mb,
                               dtype=torch.bfloat16, remat=False, lr=1e-4,
                               loss_chunk=128, moments="f32", device=dev)
    args = eng.args
    params, opt = eng.init_state(0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, args.vocab_size, (batch, seq)).astype(np.int32)
    labels = rng.integers(0, args.vocab_size, (batch, seq)).astype(np.int32)
    ids, labels = eng.shard_batch(ids, labels)
    first = None
    for _ in range(warmup):
        loss, params, opt = eng.train_batch(params, opt, ids, labels)
        first = loss if first is None else first
    torch.cuda.synchronize(dev)
    reset_launches()
    mon, lbl = eng.monitor, {"source": "hybrid_engine"}
    mfu0 = mon.registry.observation("train/mfu", labels=lbl)
    wall0 = mon.registry.observation("train/step_time_s", labels=lbl)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, params, opt = eng.train_batch(params, opt, ids, labels)
    # the gauge as the last step's end_step left it, beside the allocator's
    # high water now (nothing is allocated after that end_step)
    hbm_gauge = mon.registry.gauge("train/hbm_high_water_bytes", labels=lbl)
    hbm_now = torch.cuda.max_memory_allocated(dev)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    final = loss.item()
    tps = batch * seq * steps / secs
    mfu = tps * llama_flops_per_token(args, seq) / peaks(name)[1]
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    per_step = {k: launches[k] / steps for k in flash + NORMS}
    log(f"[{label}] hidden {args.hidden_size}, {args.num_layers} layers, b"
        f"{batch} s{seq}, {mb} micro-batches, bf16, no remat, loss_chunk "
        f"128, f32 moments: {tps:.0f} tokens/s, {secs / steps * 1e3:.1f} ms "
        f"a step, MFU {mfu:.1%} (model FLOPs over the bf16 peak), peak "
        f"device memory {peak:.1f} GiB; loss {first.item():.4f} at the "
        f"first step, {final:.4f} at the last (one batch, repeated, as "
        f"bench.py trains); B1/B2/B3/B9/B10 "
        f"launches a step {per_step}")
    mfu1 = mon.registry.observation("train/mfu", labels=lbl)
    wall1 = mon.registry.observation("train/step_time_s", labels=lbl)
    mon_mfu = (mfu1["sum"] - mfu0["sum"]) / (mfu1["count"] - mfu0["count"])
    mon_ms = (wall1["sum"] - wall0["sum"]) / steps * 1e3
    log(f"[{label}] the engine's default monitor (nan_action 'none': each "
        f"step's wall time is its dispatch, the step never waits for the "
        f"card): {mon.steps} steps, the timed steps' mean step time "
        f"{mon_ms:.1f} ms against {secs / steps * 1e3:.1f} ms synchronised "
        f"and mean MFU {mon_mfu:.1%} against {mfu:.1%} "
        f"(peak {mon.peak_flops / 1e12:.0f} TFLOP/s), HBM high water "
        f"{hbm_gauge / 2**30:.2f} GiB (torch.cuda.max_memory_allocated "
        f"{hbm_now / 2**30:.2f} GiB)")
    if mon.steps != warmup + steps or hbm_gauge != hbm_now or \
            mon.peak_flops != peaks(name)[1]:
        raise AssertionError(f"{label}: monitor steps {mon.steps}, HBM gauge "
                             f"{hbm_gauge} vs {hbm_now}, peak "
                             f"{mon.peak_flops}")
    # B1-B3 once a layer, B9/B10 once a norm (2L + 1), each micro-batch
    want = dict.fromkeys(flash, args.num_layers * mb)
    want.update(dict.fromkeys(NORMS, (2 * args.num_layers + 1) * mb))
    if not (math.isfinite(final) and per_step == want):
        raise AssertionError(f"{label}: loss {final}, launches a step "
                             f"{per_step} (want {want})")
    phase_train_profile(torch, dev, eng, params, opt, ids, labels,
                        f"{label}-profile")
    return launches


def cuda_ms(torch, fn, l2):
    """Median per-call device time of fn() in ms under the kernel table's
    method (`timing.METHOD`: CUDA events around each call, the L2 cache
    flushed before each one by `l2`, a `timing.ColdL2`)."""
    from paddle_tpu_torch.kernels import timing

    return timing.cold_ms(fn, l2)


def methods_line(torch, fn, l2):
    """fn's time under each of `timing.METHODS`, as one log fragment."""
    from paddle_tpu_torch.kernels import timing

    return ", ".join(f"{how} flush{' + sleep' if sleep else ''} {t:.4f}"
                     for (how, sleep), t in timing.methods_ms(fn, l2).items())


def cuda_ms_loop(torch, fn, iters=50):
    """Mean per-call device time of fn() issued back to back (host overhead
    hidden behind the queue, caches as the previous call left them)."""
    for _ in range(3):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return a.elapsed_time(e) / iters


def graph_ms(torch, fn, reps=200):
    """Mean device time of fn() with no host work between calls: `reps`
    calls captured into one CUDA graph, replayed once (the caches stay as
    the previous call left them). For calls that take less device time
    than the host takes to launch them, which `cuda_ms` cannot separate."""
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


def phase_timing(torch, dev, name, main_err, launches):
    import torch.nn.functional as F
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    from paddle_tpu_torch.kernels import timing

    bw, flops_peak = peaks(name)
    # two 256 MB buffers, past the 50 MB L2: the flush before each timed
    # call (`timing.METHOD` for every number of the JSON line)
    l2 = timing.ColdL2(dev)
    rows = []
    held = (", the card held by torch.cuda._sleep while the host enqueues"
            if timing.METHOD[1] else "")
    log(f"[timing] card at the start: {card_state()}; every time below is "
        f"L2 flushed by {timing.METHOD[0]}ing 256 MB{held} unless a line says "
        f"otherwise")

    def record(wrapper, fn, plain, library, nbytes, flops, label, row=True,
               methods=False):
        """Times one shape; the kernel's JSON row when `row` (True: under
        the wrapper's key of KERNELS; a string: under that key). `library`:
        a callable, or its time in ms measured already. `methods`: the
        kernel's time under every timing method, logged. Returns the
        kernel's ms and the bound's."""
        ms = cuda_ms(torch, fn, l2)
        log(f"[timing] {label}: back-to-back kernel "
            f"{cuda_ms_loop(torch, fn):.4f} ms, plain "
            f"{cuda_ms_loop(torch, plain):.4f} ms")
        if methods:
            log(f"[timing] {label}: kernel by timing method (ms): "
                f"{methods_line(torch, fn, l2)}")
        plain_ms = cuda_ms(torch, plain, l2)
        lib_ms = (library if isinstance(library, float)
                  else cuda_ms(torch, library, l2))
        t_bytes = nbytes / bw * 1e3
        t_ops = flops / flops_peak * 1e3
        bound, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                     else (t_ops, "operations"))
        log(f"[timing] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}: "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
            f"{bound / ms:.1%} of bound")
        if row:
            key = row if isinstance(row, str) else wrapper
            js, src, replaces = KERNELS[key]
            rows.append({"name": js, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": launches[key],
                         "max_abs_err": main_err[key], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound,
                         "bound_by": by, "library_ms": lib_ms})
        return ms, bound

    # B1-B3 at the 7B training leg's micro-batch (b2 h32 s2048 d128, causal,
    # bf16: the JSON rows), then B2 and B3 at the h2048 leg's (b4 h16 s1024,
    # log lines only); bounds count the visible (query, key) pairs. The
    # library call is SDPA: its forward beside B1, its backward (dq, dk and
    # dv together) beside both B2 and B3
    from paddle_tpu_torch.kernels import flash_attention as fa

    for b, s, h, d in ((2, 2048, 32, 128), (4, 1024, 16, 128)):
        main = s == 2048
        q, k, v, do = flash_case(torch, dev, b, s, s, h, h, d,
                                 torch.bfloat16)
        scale = 1.0 / math.sqrt(d)
        out, lse = fa.flash_fwd(q, k, v, True)
        delta = fa._delta(out, do)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        lq, lk, lv = (x.clone().requires_grad_() for x in (qt, kt, vt))
        lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)

        def sdpa_backward():
            return torch.autograd.grad(lout, (lq, lk, lv), dot,
                                       retain_graph=True)

        sdpa_bwd_ms = cuda_ms(torch, sdpa_backward, l2)
        log(f"[timing] SDPA backward (dq, dk, dv) b{b} h{h} s{s} d{d} "
            f"causal bf16: {sdpa_bwd_ms:.4f} ms")

        flops = 2 * d * b * h * s * (s + 1) // 2       # one product
        t16, vec = b * s * h * d * 2, b * h * s * 4     # a bf16 [B,S,H,D]
        label = f"b{b} h{h} s{s} d{d} causal bf16"
        if main:
            record("flash_fwd", lambda: fa.flash_fwd(q, k, v, True),
                   lambda: fa.flash_fwd_plain(q, k, v, True),
                   lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                          is_causal=True),
                   4 * t16 + vec, 2 * flops, f"B1 {label}")
        record("flash_bwd_dq",
               lambda: fa._launch_dq(q, k, v, do, lse, delta, True, scale),
               lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True,
                                             scale),
               sdpa_bwd_ms, 5 * t16 + 2 * vec, 3 * flops, f"B2 {label}",
               row=main)
        record("flash_bwd_dkv",
               lambda: fa._launch_dkv(q, k, v, do, lse, delta, True, scale),
               lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True,
                                              scale),
               sdpa_bwd_ms, 4 * t16 + 2 * vec + 2 * 2 * t16, 4 * flops,
               f"B3 {label}", row=main)
        del q, k, v, do, out, lse, delta, qt, kt, vt, dot, lq, lk, lv, lout
        torch.cuda.empty_cache()

    # B6 and B4 at the engine's decode shape: 8 rows, ragged up to 2048
    q, pk, pv, bt, pos = paged_case(torch, dev, torch.bfloat16)
    b, _, nh, hd = q.shape
    nkv, ps = pk.shape[1], pk.shape[2]
    keys = [int(p) + 1 for p in pos.tolist()]
    kv_bytes = sum(keys) * nkv * hd * 2 * 2
    qo_bytes = 2 * b * nh * hd * 2
    flops = 4 * nh * hd * sum(keys)
    bt_bytes = sum((k - 1) // ps + 1 for k in keys) * 4 + b * 4
    ck = at.paged_gather(pk, bt)
    cv = at.paged_gather(pv, bt)
    mask = (torch.arange(ck.shape[2], device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    record("paged_decode_attention",
           lambda: at.paged_decode_attention(q, pk, pv, bt, pos),
           lambda: at.paged_decode_attention_plain(q, pk, pv, bt, pos),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           kv_bytes + qo_bytes + bt_bytes, flops,
           "B6 b=8 nh=nkv=32 hd=128 ps=16 P=128", methods=True)
    record("decode_attention",
           lambda: at.decode_attention(q, ck, cv, pos),
           lambda: at.decode_attention_plain(q, ck, cv, pos),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           kv_bytes + qo_bytes + b * 4, flops,
           f"B4 b=8 nh=nkv=32 hd=128 len=2048, "
           f"{at.decode_splits(ck.shape[2] - 1)} "
           f"split(s)", methods=True)
    log(f"[timing] B4's shared CUDA-core body (the kernel the cluster kernel "
        f"replaced in bf16, its C entry point with splits 0), same inputs, by "
        f"timing method (ms): "
        f"{methods_line(torch, b4_shared(torch, q, ck, cv, pos), l2)}")
    # B4 at the speculative draft's stripe (h2048: 16 kv heads, 1029 keys
    # a row, ragged rows), beside the shared body
    q, ck, cv, _, _, pos = b4_case(torch, dev, torch.bfloat16,
                                   *B4_CASES[0][1:])
    keys = [min(int(p), ck.shape[2] - 1) + 1 for p in pos.tolist()]
    record("decode_attention",
           lambda: at.decode_attention(q, ck, cv, pos),
           lambda: at.decode_attention_plain(q, ck, cv, pos),
           lambda: F.scaled_dot_product_attention(
               q.transpose(1, 2), ck, cv, attn_mask=(
                   torch.arange(ck.shape[2], device=dev)[None, :]
                   <= pos[:, None].long())[:, None, None, :]),
           sum(keys) * ck.shape[1] * 128 * 2 * 2 + 2 * 8 * 16 * 128 * 2
           + 8 * 4, 4 * 16 * 128 * sum(keys),
           f"B4 at the draft's stripe, b=8 nh=nkv=16 hd=128 len=1029 "
           f"pos={pos.tolist()}", row=False)
    log(f"[timing] B4's shared body at the draft's stripe: "
        f"{cuda_ms(torch, b4_shared(torch, q, ck, cv, pos), l2):.4f} ms")
    del q, ck, cv
    # B5 at a paged-prefill suffix (16 new tokens after a 512-token hit:
    # the JSON row), then at the spec-verify window (b=8, s=5, ragged
    # rows). The library call is SDPA over the keys the kernel reads, up
    # to each batch's last watermark (PR 6 gave it the whole stripe: that
    # reading is logged beside it)
    for b, s, pos_l in ((1, 16, [512]),
                        (8, 5, [1000, 3, 64, 59, 0, 500, 127, 777])):
        q, ck, cv, pos = window_case(torch, dev, torch.bfloat16, s, b=b,
                                     length=2048 + s if b == 1 else 1100,
                                     pos=pos_l)
        nh, nkv, L = q.shape[2], ck.shape[1], ck.shape[2]
        lasts = [min(p + s - 1, L - 1) for p in pos_l]
        last = max(lasts)
        keys = sum(min(p + i, L - 1) + 1 for p in pos_l for i in range(s))
        qpos = pos[:, None, None, None].long() + torch.arange(
            s, device=dev)[None, None, :, None]
        mask = torch.arange(L, device=dev)[None, None, None, :] <= qpos
        ckr, cvr = ck[:, :, :last + 1], cv[:, :, :last + 1]
        mask_r = mask[..., :last + 1]
        qt = q.transpose(1, 2)
        if b == 1:
            stripe_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, ck, cv, attn_mask=mask), l2)
            log(f"[timing] B5's library call as PR 6 timed it, SDPA over the "
                f"whole {L}-key stripe: {stripe_ms:.4f} ms")
        splits = at.window_splits(at._window_last(pos, s, L))
        record("window_attention",
               lambda: at.window_attention(q, ck, cv, pos),
               lambda: at.window_attention_plain(q, ck, cv, pos),
               lambda: F.scaled_dot_product_attention(qt, ckr, cvr,
                                                      attn_mask=mask_r),
               sum(x + 1 for x in lasts) * nkv * hd * 2 * 2
               + 2 * b * s * nh * hd * 2 + 4 * b,
               4 * hd * (nh // nkv) * nkv * keys,
               f"B5 b={b} s={s} nh=nkv=32 hd=128 len={L} pos={pos_l}, "
               f"{splits} split(s)", row=b == 1)
        del q, ck, cv, ckr, cvr

    # B7 at the engine's decode shape over int8 pages; the library call
    # attends over the dequantized (bf16) gathered cache
    q, kq, vq, ks, vs, bt, pos = paged_q8_case(torch, dev, torch.bfloat16)
    b, _, nh, hd = q.shape
    nkv, ps = kq.shape[1], kq.shape[2]
    keys = [int(p) + 1 for p in pos.tolist()]
    pages = sum((k - 1) // ps + 1 for k in keys)
    ck = at.paged_gather(kq, bt, ks, torch.bfloat16)
    cv = at.paged_gather(vq, bt, vs, torch.bfloat16)
    mask = (torch.arange(ck.shape[2], device=dev)[None, :]
            <= pos[:, None].long())[:, None, None, :]
    qt = q.transpose(1, 2)
    record("paged_decode_attention_int8",
           lambda: at.paged_decode_attention(q, kq, vq, bt, pos, k_scale=ks,
                                             v_scale=vs),
           lambda: at.paged_decode_attention_plain(q, kq, vq, bt, pos,
                                                   k_scale=ks, v_scale=vs),
           lambda: F.scaled_dot_product_attention(qt, ck, cv, attn_mask=mask),
           sum(keys) * nkv * hd * 2 + pages * nkv * 4 * 2
           + 2 * b * nh * hd * 2 + pages * 4 + b * 4,
           4 * nh * hd * sum(keys),
           "B7 b=8 nh=nkv=32 hd=128 ps=16 P=128 int8 pool", methods=True)
    del ck, cv

    # B6 and B7 at the engine's own decode shape (phase_profile's 8 rows
    # after 256-token prompts: 256-319 keys over tables of 128 pages of
    # 16), log lines, with the bound on pos the engine's scheduler passes
    # (max_pos) and without it
    eng_pos = tuple(256 + 9 * i for i in range(8))
    keys = [p + 1 for p in eng_pos]
    for q8 in (False, True):
        if q8:
            q, kq, vq, ks, vs, bt, pos = paged_q8_case(
                torch, dev, torch.bfloat16, pos=eng_pos)
            args, kw = (q, kq, vq, bt, pos), {"k_scale": ks, "v_scale": vs}
            ck = at.paged_gather(kq, bt, ks, torch.bfloat16)
            cv = at.paged_gather(vq, bt, vs, torch.bfloat16)
            nbytes = sum(keys) * nkv * hd * 2 + 2 * b * nh * hd * 2 + \
                sum((k - 1) // ps + 1 for k in keys) * (nkv * 8 + 4) + b * 4
        else:
            args, kw = paged_case(torch, dev, torch.bfloat16,
                                  pos=eng_pos), {}
            ck, cv = (at.paged_gather(t, args[3]) for t in args[1:3])
            nbytes = sum(keys) * nkv * hd * 2 * 2 + 2 * b * nh * hd * 2 + \
                sum((k - 1) // ps + 1 for k in keys) * 4 + b * 4
        mask = (torch.arange(ck.shape[2], device=dev)[None, :]
                <= args[4][:, None].long())[:, None, None, :]
        qt = args[0].transpose(1, 2)
        kid, name = (("B7", "paged_decode_attention_int8") if q8
                     else ("B6", "paged_decode_attention"))
        splits = at.paged_splits(128, ps, max(eng_pos))
        unbound = cuda_ms(torch, lambda: at.paged_decode_attention(
            *args, **kw), l2)
        record(name,
               lambda: at.paged_decode_attention(*args, **kw,
                                                 max_pos=max(eng_pos)),
               lambda: at.paged_decode_attention_plain(*args, **kw),
               lambda: F.scaled_dot_product_attention(qt, ck, cv,
                                                      attn_mask=mask),
               nbytes, 4 * nh * hd * sum(keys),
               f"{kid} at the engine's decode shape (8 rows of 257-320 "
               f"keys, ps=16 P=128), max_pos {max(eng_pos)}: {splits} "
               f"split(s); without the bound "
               f"{at.paged_splits(128, ps)} split(s), "
               f"{unbound:.4f} ms", row=False)
        del args, kw, ck, cv

    # B8: one call per shape of the decode step at M = 8 (the JSON row: the
    # FFN's 4096 x 11008), then prefill at M = 2048 (its own row) and at
    # the int8 engine's prompt lengths 512 and 1500; the library call is
    # torch.matmul with the weight already dequantized to bf16
    step_ms = step_bound = 0.0
    for m, k, n, calls in [(8, k, n, c) for k, n, c in DECODE_MATMULS] + [
            (m, k, n, 0) for m in (1, 16) for k, n, _ in DECODE_MATMULS] + [
            (2048, 4096, 11008, 0), (512, 4096, 4096, 0),
            (512, 4096, 11008, 0), (1500, 4096, 4096, 0),
            (1500, 4096, 11008, 0)]:
        x, w, s = matmul_case(torch, dev, torch.bfloat16, m, k, n)
        wd = w.to(torch.bfloat16) * (s.to(torch.bfloat16) / 127.0)
        way = qm.route(m, k, n, x.dtype, x.data_ptr(), w.data_ptr())
        if way == "tma":
            way += f", tile {qm.tile(m, n, qm._sms(dev))}"
        else:
            way += (f", (K rows a block, cluster) "
                    f"{qm.gemv_split(k, n, qm._sms(dev))}")
        row = ("weight_only_matmul_prefill" if (m, k, n) == (2048, 4096,
                                                             11008)
               else (m, k, n) == (8, 4096, 11008))
        ms, bound = record(
            "weight_only_matmul", lambda: qm.weight_only_matmul(x, w, s),
            lambda: qm.dequant_matmul_plain(x, w, s),
            lambda: torch.matmul(x, wd),
            k * n + n * 4 + m * k * 2 + m * n * 2, 2 * m * k * n,
            f"B8 M={m} K={k} N={n} ({way})", row=row)
        step_ms += calls * ms
        step_bound += calls * bound
        del x, w, s, wd
    n_calls = sum(c for *_, c in DECODE_MATMULS)
    log(f"[timing] B8 over one decode step at M=8 ({n_calls} calls): "
        f"{step_ms:.3f} ms of kernel time, bound {step_bound:.3f} ms")

    # B9 and B10 at the 7B training leg's micro-batch (the JSON rows) and
    # at the decode step's 8 rows, bf16; the library calls are
    # F.rms_norm's forward and its autograd backward
    from paddle_tpu_torch.kernels import rms_norm as rn

    for n, h in ((4096, 4096), (4096, 2048), (8, 4096)):
        x, w, g = rms_case(torch, dev, n, h, torch.bfloat16)
        _, r = rn.rms_norm_fwd(x, w, RMS_EPS)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        yl = F.rms_norm(xl, (h,), wl, RMS_EPS)

        def lib_backward():
            return torch.autograd.grad(yl, (xl, wl), g, retain_graph=True)

        t16 = n * h * 2
        main = (n, h) == (4096, 4096)
        record("rms_norm_fwd", lambda: rn.rms_norm_fwd(x, w, RMS_EPS),
               lambda: rn.rms_norm_fwd_plain(x, w, RMS_EPS),
               lambda: F.rms_norm(x, (h,), w, RMS_EPS),
               2 * t16 + h * 2 + n * 4, 4 * n * h,
               f"B9 [{n}, {h}] bf16", row=main)
        record("rms_norm_bwd", lambda: rn.rms_norm_bwd(x, w, r, g),
               lambda: rn.rms_norm_bwd_plain(x, w, r, g), lib_backward,
               3 * t16 + 2 * h * 2 + n * 4, 9 * n * h,
               f"B10 [{n}, {h}] bf16, (blocks, cluster) "
               f"{rn.bwd_grid(n, h, 2, qm._sms(dev))}", row=main,
               methods=True)

        def lib_both():
            xg = x.detach().requires_grad_()
            wg = w.detach().requires_grad_()
            return torch.autograd.grad(F.rms_norm(xg, (h,), wg, RMS_EPS),
                                       (xg, wg), g)

        # device time alone, from CUDA graphs: at 8 rows the host launches
        # a call slower than the card runs it
        log(f"[timing] B9/B10 [{n}, {h}] bf16 from CUDA graphs (device "
            f"time, no host launch work): B9 "
            f"{graph_ms(torch, lambda: rn.rms_norm_fwd(x, w, RMS_EPS)):.4f}"
            f" ms, F.rms_norm "
            f"{graph_ms(torch, lambda: F.rms_norm(x, (h,), w, RMS_EPS)):.4f}"
            f" ms; B10 "
            f"{graph_ms(torch, lambda: rn.rms_norm_bwd(x, w, r, g)):.4f} ms"
            f", F.rms_norm forward and backward "
            f"{graph_ms(torch, lib_both):.4f} ms")
        del x, w, g, r, xl, wl, yl
    log(f"[timing] card at the end: {card_state()}")
    return rows


def card_state():
    """The card's SM and memory clocks, temperature and power draw now
    (nvidia-smi), to read beside the times."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()


# ---------------------------------------------------------------------------
# the main path: the paged engine and generate at Llama-2-7B width
# ---------------------------------------------------------------------------


def engine_traffic(vocab, seed=0):
    """12 requests, 64 new tokens each. Six share a 512-token system prefix
    (radix hits); two of those also share 7 tokens past it, so the second
    one's hit ends mid-page (a COW split); a 40-token suffix after the
    prefix and the 24-, 64-token prompts prefill through kernel B5; two
    requests sample."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def u(n):
        return rng.integers(1, vocab, size=n).astype(np.int32)

    sys_p, x7 = u(512), u(7)
    cat = np.concatenate
    return [
        dict(prompt=cat([sys_p, u(100)])),
        dict(prompt=u(24)),
        dict(prompt=u(1500)),
        dict(prompt=cat([sys_p, x7, u(33)])),
        dict(prompt=cat([sys_p, x7, u(45)])),
        dict(prompt=cat([sys_p, u(40)])),
        dict(prompt=u(300), temperature=0.8, top_p=0.9, seed=7),
        dict(prompt=cat([sys_p, u(200)])),
        dict(prompt=u(800)),
        dict(prompt=u(64), temperature=1.0, top_k=50, seed=11),
        dict(prompt=cat([sys_p, u(10)])),
        dict(prompt=u(1000)),
    ]


def phase_engine(torch, dev, model, kv_dtype=None, label="engine",
                 max_slots=8, max_len=2048, page_size=16, min_bucket=16,
                 new_tokens=64):
    """Serve the traffic; returns (requests, launches, stats, engine)."""
    from paddle_tpu_torch.serving import PagedEngine, Request

    eng = PagedEngine(model, max_slots=max_slots, max_len=max_len,
                      page_size=page_size, min_bucket=min_bucket,
                      kv_dtype=kv_dtype, device=dev)
    eng.serve([Request(list(range(1, 21)), 4)])      # warm-up, not counted
    eng.reset()
    traffic = engine_traffic(model.args.vocab_size)
    reqs = [Request(t.pop("prompt"), new_tokens, request_id=i, **t)
            for i, t in enumerate(traffic)]
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    eng.serve(reqs)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()

    m = eng.metrics.summary()
    c = m["counters"]
    n_tok = sum(len(r.token_ids) for r in reqs)
    # TTFT from the requests themselves (the registry's quantiles are
    # interpolated inside 1-2.5-5 buckets, too coarse for 12 requests)
    ttft = [r.ttft_s for r in reqs]
    ttft_p50 = statistics.median(ttft)
    pool_bytes = int(m["gauges"]["kv_pool_bytes"]["value"])
    log(f"[{label}] {len(reqs)} requests, {n_tok} tokens in {secs:.2f} s: "
        f"{n_tok / secs:.1f} tokens/s, TTFT p50 {ttft_p50 * 1e3:.1f} ms "
        f"max {max(ttft) * 1e3:.1f} ms; decode step p50 "
        f"{m['observations']['decode_step_s']['p50'] * 1e3:.2f} ms "
        f"(bucket-interpolated), {c['decode_steps']} decode steps; pool "
        f"{eng.num_pages} pages, {pool_bytes / 2**30:.3f} GiB")
    log(f"[{label}] prefix tokens hit {c.get('prefix_tokens_hit', 0)} of "
        f"{c['prompt_tokens']}, partial hits "
        f"{c.get('prefix_partial_hits', 0)}, "
        f"radix splits {c.get('radix_splits', 0)}, COW copies "
        f"{c.get('cow_copies', 0)}; launches {launches}")
    vocab = model.args.vocab_size
    for r in reqs:
        if not (r.finished and len(r.token_ids) == new_tokens
                and all(0 <= t < vocab for t in r.token_ids)):
            raise AssertionError(f"request {r.request_id} did not complete "
                                 f"cleanly: {r.finish_reason}, "
                                 f"{len(r.token_ids)} tokens")
    paged = ("B7 launched", "paged_decode_attention_int8") if kv_dtype \
        else ("B6 launched", "paged_decode_attention")
    checks = {"prefix hits": c.get("prefix_tokens_hit", 0) >= 5 * 512,
              "mid-page partial hit": c.get("prefix_partial_hits", 0) >= 1,
              "COW copy": c.get("cow_copies", 0) >= 1,
              "radix split": c.get("radix_splits", 0) >= 1,
              "B5 launched": launches["window_attention"] > 0,
              paged[0]: launches[paged[1]] > 0,
              "pages returned": eng._alloc.pages_in_use == 0}
    if model.quantized:
        checks["B8 launched"] = launches["weight_only_matmul"] > 0
        checks["B8 prefill (TMA) route launched"] = \
            launches["weight_only_matmul_prefill"] > 0
        checks["B8 off-gate route not launched"] = \
            launches["weight_only_matmul_offgate"] == 0
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"{label} phase: {failed}")
    stats = {"tokens_per_s": n_tok / secs, "ttft_p50_s": ttft_p50,
             "ttft_max_s": max(ttft),
             "decode_step_p50_s": m["observations"]["decode_step_s"]["p50"],
             "decode_steps": c["decode_steps"], "seconds": secs,
             "counters": c, "kv_pool_bytes": pool_bytes,
             "num_pages": eng.num_pages}
    return reqs, launches, stats, eng


# kernel-name fragments of each ported kernel in a profiler trace
PROFILE_NAMES = {"B1": ("flash_fwd",), "B2": ("flash_bwd_dq",),
                 "B3": ("flash_bwd_dkv",),
                 "B5": ("window_mma_kernel", "window_attention_kernel"),
                 "B4": ("CacheKeys", "::decode_attention_kernel<"),
                 "B6": ("PagedKeys<__nv_bfloat16",
                        "paged_decode_attention_kernel"),
                 "B7": ("PagedKeys<signed char", "PagedKeys<char",
                        "paged_decode_attention_q8_kernel"),
                 "B8": ("b8_gemv_mma_kernel", "b8_gemv_kernel",
                        "b8_reduce_kernel",
                        "b8_tma_kernel", "b8_mma_kernel", "b8_simt_kernel"),
                 "B9": ("rms_norm_fwd_kernel",),
                 "B10": ("rms_norm_bwd_kernel",)}


# kernel launches a decode step in the last run before B9 (PERF.md)
LAUNCHES_BEFORE_B9 = {"profile": 1682, "profile-int8": 3218}
# ... in the last run before B6/B7 were split over clusters (PERF.md), which
# the step may not exceed, and the paged kernel each profile must see once
# a layer a step
LAUNCH_CEILING = {"profile": 1227, "profile-int8": 2538}
PAGED_KERNEL = {"profile": "B6", "profile-int8": "B7"}


def phase_profile(torch, dev, eng, label="profile", n_steps=8,
                  prompt_len=256):
    """Where a decode step's time goes: 8 rows at 256-token prompts, n_steps
    decode steps under torch.profiler; the device-busy share is kernel time
    over wall time. Reports "not measured" when the profiler sees no
    device activity."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch.serving import Request

    eng.reset()
    rng = np.random.default_rng(9)
    for i in range(eng.max_slots):
        eng.submit(Request(rng.integers(1, eng.args.vocab_size, prompt_len),
                           n_steps + 2, request_id=1000 + i))
    while eng.queue:
        eng.step()
    eng.step()                                   # one unprofiled decode
    torch.cuda.synchronize(dev)
    before = launch_counts()["rms_norm_fwd"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize(dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    norms = (launch_counts()["rms_norm_fwd"] - before) / n_steps
    eng.run_until_idle()
    want = 2 * eng.args.num_layers + 1
    if norms != want:
        raise AssertionError(f"{label}: B9 launched {norms} times a decode "
                             f"step, want {want} (one a norm)")
    kern = [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kern)
    if not kern:
        log(f"[{label}] device time not measured: the profiler saw no "
            "device activity")
        return None
    n_launch = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    log(f"[{label}] {n_steps} decode steps at {eng.max_slots} rows, "
        f"{prompt_len}-token prompts: wall {wall_us / n_steps / 1e3:.2f} ms "
        f"a step, device busy {busy_us / n_steps / 1e3:.2f} ms a step "
        f"({busy_us / wall_us:.1%}), {n_launch / n_steps:.0f} kernel "
        f"launches a step ({LAUNCHES_BEFORE_B9[label]} in another run "
        f"before the norms were fused), B9 {norms:.0f} a step")
    for e in top:
        log(f"[{label}]   {e.self_device_time_total / busy_us:6.1%} "
            f"{e.count / n_steps:5.0f}/step  {e.key[:90]}")
    for kid, frags in PROFILE_NAMES.items():
        mine = [e for e in kern if any(f in e.key for f in frags)]
        if mine:
            us = sum(e.self_device_time_total for e in mine)
            log(f"[{label}]   {kid}: {us / busy_us:.1%} of device time, "
                f"{us / n_steps / 1e3:.3f} ms and "
                f"{sum(e.count for e in mine) / n_steps:.0f} launches a step")
    kid = PAGED_KERNEL[label]
    paged = sum(e.count for e in kern
                if any(f in e.key for f in PROFILE_NAMES[kid])) / n_steps
    if paged != eng.args.num_layers or \
            n_launch / n_steps > LAUNCH_CEILING[label] + 0.5:
        raise AssertionError(
            f"{label}: {kid} launched {paged} times a decode step (want "
            f"{eng.args.num_layers}), {n_launch / n_steps} launches a step "
            f"(at most {LAUNCH_CEILING[label]})")
    return {"wall_ms": wall_us / n_steps / 1e3,
            "busy_ms": busy_us / n_steps / 1e3,
            "launches_per_step": n_launch / n_steps}


def _widen(leaf, dtype):
    """A weight in `dtype` (f32 or f64): a float tensor upcast, or an int8
    QuantizedWeight dequantized (q * scale / 127)."""
    from paddle_tpu_torch.models import QuantizedWeight

    if isinstance(leaf, QuantizedWeight):
        return leaf.q.to(dtype) * (leaf.scale.to(dtype) / 127.0).unsqueeze(-2)
    return leaf.to(dtype)


def _attention(torch, q, k, v):
    """Causal softmax attention in f32 of q [Tq, nh, hd] over k, v
    [Tk, nkv, hd] (GQA); query i sits at position Tk - Tq + i."""
    Tq, Tk, hd = q.shape[0], k.shape[0], q.shape[-1]
    g = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    s = (q.transpose(0, 1) @ k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril(
        Tk - Tq)
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return (p @ v).transpose(0, 1)


def int8_pool_attention(torch, n, page_size):
    """The attention an int8 page pool gives, written out in f32 from the
    reference's semantics and sharing no code with the port: the n prompt
    positions attend to their own K/V unrounded (the prefill); their pages
    are then quantized per (page, kv head) over the prompt's positions
    (absmax, x / absmax * 127 rounded half to even, 0 past the prompt;
    `paged_engine._paged_prefill`); each later position is written with
    the running absmax, restarted at offset 0, the page's codes rescaled
    as round(q * old / new) (`generation._kv_quant_write`), and then
    attends over the dequantized pages (q * scale / 127)."""
    ps = page_size

    def quantize_prompt(x):
        P = -(-x.shape[0] // ps)
        xp = x.new_zeros(P * ps, *x.shape[1:])
        xp[:n] = x[:n]
        xp = xp.view(P, ps, *x.shape[1:])
        scale = xp.abs().amax(dim=(1, 3))                    # [P, nkv]
        codes = torch.round(xp / scale.clamp(min=1e-9)[:, None, :, None]
                            * 127.0).clamp(-127, 127)
        return codes, scale

    def write(codes, scale, t, x):
        p, off = divmod(t, ps)
        old = torch.zeros_like(scale[p]) if off == 0 else scale[p]
        new = torch.maximum(old, x.abs().amax(dim=-1))
        safe = new.clamp(min=1e-9)
        page = codes[p] * (old / safe)[None, :, None]
        page[off] = x / safe[:, None] * 127.0
        codes[p] = torch.round(page).clamp(-127, 127)
        scale[p] = new

    def dequantize(codes, scale, t):
        return (codes * (scale / 127.0)[:, None, :, None]).flatten(0, 1)[
            :t + 1]

    def attend(q, k, v):
        out = torch.empty_like(q)
        out[:n] = _attention(torch, q[:n], k[:n], v[:n])
        (ck, sk), (cv, sv) = quantize_prompt(k), quantize_prompt(v)
        for t in range(n, q.shape[0]):
            write(ck, sk, t, k[t])
            write(cv, sv, t, v[t])
            out[t] = _attention(torch, q[t:t + 1], dequantize(ck, sk, t),
                                dequantize(cv, sv, t))[0]
        return out

    return attend


def _norm(torch, x, w, eps):
    """RMSNorm written out, sharing no code with the port: normalise in
    f32, cast back to x's dtype (an f64 forward's norms round through f32),
    scale by w."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r).to(x.dtype) * w


def reference_logits(torch, model, ids, attend=None, dtype=None):
    """Plain full-sequence forward with no cache, in f32 from the model's
    weights (upcast, or dequantized, one layer at a time): logits
    [T, vocab] f32. The norms are written here (`_norm`), not the port's
    B9. `attend(q, k, v)` ([T, heads, hd] each) replaces causal attention
    over the unrounded K/V (`int8_pool_attention`); `dtype` float64 runs
    the matmuls and the attention in f64 (the norms and RoPE still round
    through f32)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.models import llama_functional as lf

    a = model.args
    T, hd = ids.shape[0], a.head_dim
    attend = attend or (lambda q, k, v: _attention(torch, q, k, v))
    dtype = dtype or torch.float32
    cos, sin = lf.rope_tables(T, hd, a.rope_theta, ids.device)
    h = model.embedding[ids.long()].to(dtype)[None]
    for i in range(a.num_layers):
        lp = {k: _widen(v, dtype) for k, v in model.layer(i).items()}
        x = _norm(torch, h, lp["ln1"], a.rms_eps)
        q = (x @ lp["wq"]).view(1, T, a.num_heads, hd)
        k = (x @ lp["wk"]).view(1, T, a.num_kv_heads, hd)
        v = (x @ lp["wv"]).view(1, T, a.num_kv_heads, hd)
        q, k = lf.apply_rope(q, k, cos, sin)
        o = attend(q[0], k[0], v[0])
        h = h + o.reshape(1, T, -1) @ lp["wo"]
        x = _norm(torch, h, lp["ln2"], a.rms_eps)
        h = h + (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"]
    h = _norm(torch, h, model.final_norm.to(dtype), a.rms_eps)
    return (h @ _widen(model.lm_head, dtype))[0].float()


# paged logits vs an f32 forward: relative error of the logit matrix,
# largest difference against the largest logit, top-1 agreement.
#   bf16 (set before the first run, PERF.md): the paged path rounds
#     activations, K/V and probabilities to bf16 in every one of 32 layers.
#   f32: both sides compute in f32 with TF32 off and differ only in the
#     order of their sums.
#   int8 weights are held to these bars against the f32 forward of their
#     own dequantized values (q * scale / 127): B8 sums the same codes, so
#     what remains is rounding. The int8 pool is held against the f32
#     forward with the pool's rounding written out (`int8_pool_attention`).
#   int8 pool in f32 (set after the f32 bars failed at 7B width, PERF.md
#     section 6): rounding is discontinuous, so the ~1e-5 by which two f32
#     paths differ lands a few codes on the neighbouring one in every
#     layer; those flips moved the logits by 1.3e-3 where the f32 bars
#     allowed 1e-3. The bars sit ~4x above that and an order of magnitude
#     below what the pool's rounding itself moves (~0.09), which is less
#     than what a wrong page scale or a dropped rescale moves. The f64
#     reference measures the floor that flips alone give.
#   int8 pool in bf16 (set before its first run): rounding every K/V
#     value to 1/254 of its page's absmax lands on another code wherever
#     the bf16 path's K/V have drifted from the f32 ones by a fraction of a
#     code step, as they have in the later layers; the two roundings then
#     add. Top-1 is recorded, not held (ROADMAP.md section C).
LOGIT_BARS = {"bfloat16": {"rel_err": 0.10, "max_abs_over_max": 0.15,
                           "top1": 0.80},
              "float32": {"rel_err": 1e-3, "max_abs_over_max": 1e-3,
                          "top1": 0.98},
              "int8 pool": {"rel_err": 0.20, "max_abs_over_max": 0.25,
                            "top1": None},
              "int8 pool, f32": {"rel_err": 5e-3, "max_abs_over_max": 1e-2,
                                 "top1": 0.98}}


def as_f32(model):
    """An f32 copy of the model's weights (27 GB at Llama-2-7B width); int8
    weights are dequantized (q * scale / 127)."""
    import torch
    from paddle_tpu_torch.models import Llama

    f32 = torch.float32
    return Llama(model.args, {
        "embedding": model.embedding.float(),
        "layers": {k: _widen(v, f32)
                   for k, v in model.tree()["layers"].items()},
        "final_norm": model.final_norm.float(),
        "lm_head": _widen(model.lm_head, f32)})


def paged_logits(torch, dev, model, req, page_size=16, kv_dtype=None):
    """The request's prompt + generated tokens, teacher-forced: prefill,
    then one paged_decode_step per generated token over a page pool
    holding the prefill's cache (an int8 pool quantizes its pages as the
    engine's prefill does). Returns the next-token logits [m, vocab] f32
    of positions n-1 .. n+m-2."""
    import numpy as np
    from paddle_tpu_torch.models import QuantizedKVPage
    from paddle_tpu_torch.models import generation as gen
    from paddle_tpu_torch.serving.paged_engine import _scatter_pages

    a = model.args
    prompt = req.prompt_ids
    gen_toks = np.asarray(req.token_ids, np.int32)
    n, m = prompt.size, gen_toks.size
    max_len = -(-(n + m) // page_size) * page_size
    P = max_len // page_size
    logits0, ck, cv = gen.prefill(model, prompt[None], max_len, device=dev)
    shape = (a.num_layers, 1 + P, a.num_kv_heads, page_size, a.head_dim)
    pages = torch.arange(1, P + 1, device=dev)
    valid = (torch.arange(max_len, device=dev) < n).reshape(P, page_size)
    pools = []
    for c in (ck, cv):
        new = c[:, 0].reshape(a.num_layers, a.num_kv_heads, P, page_size,
                              a.head_dim).transpose(1, 2)
        if kv_dtype:
            pool = QuantizedKVPage(
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:3], dtype=torch.float32, device=dev))
        else:
            pool = torch.zeros(shape, dtype=model.dtype, device=dev)
        _scatter_pages(pool, pages, new, valid)
        pools.append(pool)
    del ck, cv
    pk, pv = pools
    bt = pages.to(torch.int32)[None]
    rows = [logits0[0]]
    for i in range(m - 1):
        lg, _, _ = gen.paged_decode_step(
            model, torch.tensor([int(gen_toks[i])], device=dev), pk, pv, bt,
            torch.tensor([n + i], dtype=torch.int32, device=dev), page_size,
            device=dev)
        rows.append(lg[0])
    return torch.stack(rows)


def forward_ids(torch, dev, req):
    import numpy as np

    return torch.from_numpy(np.concatenate(
        [req.prompt_ids, np.asarray(req.token_ids, np.int32)])).to(dev)


def compare(torch, label, what, paged, ref, bars=None):
    """Error statistics of `paged` against `ref` [m, vocab]; raises when a
    bar is missed (bars None, or a top-1 bar of None: recorded, not
    held)."""
    err = (paged - ref).abs()
    stats = {"max_abs_err": err.max().item(),
             "max_abs_over_max": (err.max() / ref.abs().max()).item(),
             "rel_err": ((paged - ref).norm() / ref.norm()).item(),
             "top1": (paged.argmax(-1) == ref.argmax(-1)).float().mean()
             .item(),
             "positions": paged.shape[0]}
    held = bars or {"rel_err": None, "max_abs_over_max": None, "top1": None}
    shown = {k: "recorded, not held" if b is None else b
             for k, b in held.items()}
    log(f"[{label}] {what}, {stats['positions']} positions: "
        f"max_abs_err {stats['max_abs_err']:.3e} "
        f"({stats['max_abs_over_max']:.3e} of the largest logit, bar "
        f"{shown['max_abs_over_max']}), rel_err {stats['rel_err']:.3e} "
        f"(bar {shown['rel_err']}), top-1 agreement {stats['top1']:.3f} "
        f"(bar {shown['top1']})")
    ok = torch.isfinite(paged).all().item() and all(
        b is None or (stats[k] >= b if k == "top1" else stats[k] <= b)
        for k, b in held.items())
    if not ok:
        raise AssertionError(f"{what}: {stats}")
    return stats


def phase_logits(torch, dev, model, req):
    """bf16 paged logits against the plain f32 forward of the same weights,
    then the paged path with the weights in f32 against the same forward."""
    n = req.prompt_ids.size
    ref = reference_logits(torch, model, forward_ids(torch, dev, req))
    ref = ref[n - 1:n - 1 + len(req.token_ids)]
    compare(torch, "logits", f"bf16 weights vs the f32 forward, after a "
            f"{n}-token prompt", paged_logits(torch, dev, model, req), ref,
            LOGIT_BARS["bfloat16"])
    f32 = as_f32(model)
    compare(torch, "logits", "f32 weights vs the f32 forward",
            paged_logits(torch, dev, f32, req), ref, LOGIT_BARS["float32"])


def phase_logits_cuts(torch, dev, model, req):
    """The logits phase's bf16 check, recorded and not held, with the
    decode rows' keys (B6, 9-10 tiles) cut over 1, 2, 3 and 4 splits
    (`attention.PAGED_SPLIT_TILES` set by hand to 16, 5, 4 and 3): how far
    its statistics move with the rounding of one kernel's split alone."""
    from paddle_tpu_torch.kernels import attention as at

    n = req.prompt_ids.size
    ref = reference_logits(torch, model, forward_ids(torch, dev, req))
    ref = ref[n - 1:n - 1 + len(req.token_ids)]
    saved = at.PAGED_SPLIT_TILES
    try:
        for tiles in (16, 5, 4, 3):
            at.PAGED_SPLIT_TILES = tiles
            compare(torch, "logits-cuts", f"bf16 weights vs the f32 forward, "
                    f"after a {n}-token prompt, {tiles} tiles a split",
                    paged_logits(torch, dev, model, req), ref)
    finally:
        at.PAGED_SPLIT_TILES = saved


def phase_logits_int8(torch, dev, qmodel, req, page_size=16):
    """int8 weights against the f32 forward of their dequantized values:
    (a) with the bf16 pool; (b) with the int8 pool, against that forward
    with the pool's rounding written out, and the same in f32 (the
    check that leaves no room for a fault). Recorded beside: the floor
    the code flips of f32 summation order give (the reference against
    itself with f64 matmuls), and what the int8 pool's rounding itself
    moves (the two f32 forwards against each other)."""
    n = req.prompt_ids.size
    ids = forward_ids(torch, dev, req)[:-1]
    ref = reference_logits(torch, qmodel, ids)[n - 1:]
    compare(torch, "logits-int8", f"(a) int8 weights, bf16 pool vs the f32 "
            f"forward, after a {n}-token prompt",
            paged_logits(torch, dev, qmodel, req, page_size), ref,
            LOGIT_BARS["bfloat16"])
    ref8 = reference_logits(torch, qmodel, ids, int8_pool_attention(
        torch, n, page_size))[n - 1:]
    q8 = paged_logits(torch, dev, qmodel, req, page_size, kv_dtype="int8")
    compare(torch, "logits-int8", "(b) int8 weights, int8 pool vs the f32 "
            "forward over the int8 pool's rounding", q8, ref8,
            LOGIT_BARS["int8 pool"])
    f32 = as_f32(qmodel)
    q8_f32 = paged_logits(torch, dev, f32, req, page_size, kv_dtype="int8")
    del f32
    compare(torch, "logits-int8", "(b) in f32: the int8-pool path with f32 "
            "weights vs the same forward", q8_f32, ref8,
            LOGIT_BARS["int8 pool, f32"])
    ref8_64 = reference_logits(torch, qmodel, ids, int8_pool_attention(
        torch, n, page_size), dtype=torch.float64)[n - 1:]
    compare(torch, "logits-int8", "floor: that forward vs itself with f64 "
            "matmuls and attention", ref8, ref8_64)
    compare(torch, "logits-int8", "the int8 pool's rounding: the f32 "
            "forward over it vs the f32 forward", ref8, ref)


def phase_generate(torch, dev, model, b=4, lengths=(48, 128), new_tokens=32,
                   label="generate"):
    """`generate` (the stripe cache) at b=4; returns the launch counts."""
    import numpy as np
    from paddle_tpu_torch.models import generate

    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, model.args.vocab_size, size=(b, s)).astype(
        np.int32) for s in lengths]
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    outs = [generate(model, p, max_new_tokens=new_tokens, device=dev)
            for p in prompts]
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    for p, o in zip(prompts, outs):
        o = o.cpu().numpy()
        if o.shape != (b, p.shape[1] + new_tokens) or \
                not (o[:, :p.shape[1]] == p).all() or \
                not ((o >= 0) & (o < model.args.vocab_size)).all():
            raise AssertionError(f"generate output malformed: {o.shape}")
    log(f"[{label}] b={b} prompts {list(lengths)}, {new_tokens} new tokens "
        f"each, in {secs:.2f} s; launches {launches}")
    need = ["decode_attention", "window_attention"] + (
        ["weight_only_matmul"] if model.quantized else [])
    if not all(launches[k] > 0 for k in need):
        raise AssertionError(f"generate did not run {need}: {launches}")
    log(f"[{label}] B4: {launches['decode_attention']} launches on its "
        f"{b4_route(model.dtype)}")
    return launches


def b4_route(dtype):
    """Which of B4's kernels a call in `dtype` launches, in words."""
    from paddle_tpu_torch.kernels import attention as at

    return ("cluster route (decode_mma_kernel, keys by TMA)"
            if at.paged_route(dtype) == "cluster"
            else "shared body") + f" ({str(dtype).replace('torch.', '')})"


def _quantile(xs, q):
    """bench.py's quantile (`_bench_chunked_prefill` :576)."""
    xs = sorted(xs)
    return xs[min(int(q * len(xs)), len(xs) - 1)]


def phase_chunked(torch, dev, model, seed=0):
    """Chunked prefill against monolithic prefill at the reference's TPU
    settings (bench.py `_bench_chunked_prefill` :537-546): 16 slots,
    max_len 2048, pages of 64, chunks of 256, buckets from 64; a burst of 2
    long prompts (1536 tokens) dropped into 32 short ones (24-96 tokens),
    arriving 2.5 steps apart, 32 new tokens each. Holds: every request
    completes with its tokens, 2 chunked prefills, the chunk count the
    prompts imply. Records the short requests' TTFT (p50, p99) of both runs
    and their p99 ratio (the reference's bar, <= 0.5 on its TPU, is
    recorded, not held), tokens/s, and the greedy agreement of the two runs.
    Returns the launch counts of the chunked run."""
    from paddle_tpu_torch.serving import (PagedEngine, make_mixed_trace,
                                          trace_stats)

    slots, max_len, ps, chunk, min_bucket = 16, 2048, 64, 256, 64
    trace = make_mixed_trace(seed=seed, n_short=32,
                             short_len_choices=(24, 40, 57, 96), n_long=2,
                             long_len=1536, mean_interarrival_steps=2.5,
                             new_tokens_choices=(32,), long_new_tokens=32,
                             vocab_size=model.args.vocab_size)
    long_ids = {t["request_id"] for t in trace if t["long"]}
    runs = {}
    for mode, prefill_chunk in (("monolithic", None), ("chunked", chunk)):
        eng = PagedEngine(model, max_slots=slots, max_len=max_len,
                          page_size=ps, min_bucket=min_bucket,
                          prefill_chunk=prefill_chunk, device=dev)
        torch.cuda.synchronize(dev)
        reset_launches()
        t0 = time.perf_counter()
        reqs = eng.replay(trace)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        launches = launch_counts()
        m = eng.metrics.summary()
        c = m["counters"]
        short = [r.ttft_s for r in reqs if r.request_id not in long_ids]
        long_max = max(r.ttft_s for r in reqs if r.request_id in long_ids)
        toks = sum(len(r.token_ids) for r in reqs)
        runs[mode] = {"reqs": reqs, "launches": launches,
                      "p50": _quantile(short, 0.5),
                      "p99": _quantile(short, 0.99)}
        obs = m["observations"]
        pre, dec = obs["prefill_s"], obs["decode_step_s"]
        log(f"[chunked] {mode}: {len(reqs)} requests, {toks} tokens in "
            f"{secs:.2f} s ({toks / secs:.1f} tokens/s), {eng.step_count} "
            f"steps: {pre['count']} prefill windows (mean "
            f"{pre['mean'] * 1e3:.1f} ms, max {pre['max'] * 1e3:.1f} ms, "
            f"{pre['sum']:.2f} s in all), {dec['count']} decode steps (mean "
            f"{dec['mean'] * 1e3:.1f} ms, {dec['sum']:.2f} s in all); "
            f"short TTFT p50 {runs[mode]['p50'] * 1e3:.1f} ms, p99 "
            f"{runs[mode]['p99'] * 1e3:.1f} ms; long TTFT max "
            f"{long_max * 1e3:.1f} ms; chunked prefills "
            f"{c.get('chunked_prefills', 0)}, chunks "
            f"{c.get('prefill_chunks', 0)}, prefill stall steps "
            f"{int(m['gauges'].get('prefill_stall_steps', {}).get('max', 0))}"
            f"; launches {launches}")
        for r in reqs:
            if not (r.finished and len(r.token_ids) == r.max_new_tokens):
                raise AssertionError(f"chunked ({mode}): request "
                                     f"{r.request_id} did not complete")
        if prefill_chunk:
            want = sum(-(-len(t["prompt"]) // chunk) for t in trace
                       if len(t["prompt"]) > chunk)
            if c.get("chunked_prefills", 0) != len(long_ids) or \
                    c.get("prefill_chunks", 0) != want:
                raise AssertionError(f"chunked: {c.get('chunked_prefills')} "
                                     f"streams, {c.get('prefill_chunks')} "
                                     f"chunks (want {len(long_ids)}, {want})")
        del eng
        torch.cuda.empty_cache()
    mono, chk = runs["monolithic"], runs["chunked"]
    same = [x.token_ids == y.token_ids for x, y in zip(mono["reqs"],
                                                       chk["reqs"])]
    agree = [sum(a == b for a, b in zip(x.token_ids, y.token_ids))
             / len(x.token_ids) for x, y in zip(mono["reqs"], chk["reqs"])]
    log(f"[chunked] trace {trace_stats(trace)}; short TTFT p99 chunked / "
        f"monolithic {chk['p99'] / mono['p99']:.3f} (the reference's bar "
        f"on its TPU was <= 0.5: recorded, not held); greedy tokens of the "
        f"two runs: {sum(same)} of {len(same)} requests equal, mean token "
        f"agreement {sum(agree) / len(agree):.3f} (bf16: recorded; the "
        f"CPU tests hold exactness)")
    need = ("rms_norm_fwd", "window_attention", "paged_decode_attention")
    if not all(chk["launches"][k] > 0 for k in need):
        raise AssertionError(f"chunked: {need} not all launched: "
                             f"{chk['launches']}")
    return chk["launches"]


def spec_model(torch, dev, dtype, draft_layers=4):
    """`_bench_speculative`'s target at its TPU settings (bench.py
    :629-639): h2048, 16 layers, 16 heads, vocab 32000, random weights
    from seed 0 whose later layers' wo and w_down are damped to 0.02 (a
    stand-in for a trained draft's agreement), and its 4-layer draft."""
    from paddle_tpu_torch.models import Llama, LlamaArgs, init_params
    from paddle_tpu_torch.models import draft_from_params

    args = LlamaArgs(vocab_size=32000, hidden_size=2048,
                     intermediate_size=5504, num_layers=16, num_heads=16,
                     num_kv_heads=16, rope_theta=1e4, rms_eps=1e-6,
                     use_flash=False)
    gen_ = torch.Generator(device=dev).manual_seed(0)
    params = init_params(args, gen_, device=dev, dtype=dtype)
    damp = torch.tensor([1.0] * draft_layers
                        + [0.02] * (args.num_layers - draft_layers),
                        device=dev).reshape(-1, 1, 1).to(dtype)
    for k in ("wo", "w_down"):
        params["layers"][k] = params["layers"][k] * damp
    target = Llama(args, params)
    return target, draft_from_params(target, draft_layers)


def _serve_trace(torch, dev, model, trace, **kw):
    """One replay of `trace` through a PagedEngine at the speculative leg's
    settings: (requests, seconds, metrics summary, launches)."""
    from paddle_tpu_torch.serving import PagedEngine

    eng = PagedEngine(model, max_slots=8, max_len=1024, page_size=64,
                      min_bucket=64, device=dev, **kw)
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    reqs = eng.replay(trace)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    return reqs, secs, eng.metrics.summary(), launch_counts()


def phase_spec(torch, dev, model):
    """Speculative decoding. (a) parity: `_bench_speculative`'s settings
    (`spec_model`, spec_tokens 4, 8 slots, max_len 1024, pages of 64,
    make_trace seed 0: 24 requests of 24-96 tokens, 128 new tokens each) in
    f32, plain greedy against speculative: equal token for token, as
    bench.py asserts (:682-685). (b) speed: the same in bf16, tokens/s of
    both and their ratio (the reference's bar, >= 1.5x on its TPU, is
    recorded, not held). (c) Llama-2-7B width: the engine phase's model
    with its 4-layer draft, 4 greedy requests x 32 tokens, one at a time,
    beside a plain engine brought to the same positions after each round:
    the block tables, refcounts and reservations must be equal after every
    round (a random 7B draft is rejected in most rounds, so this holds the
    all-rejected rollback at full width).
    Returns the launch counts of (b)'s speculative run."""
    import numpy as np
    from paddle_tpu_torch.models import draft_from_params
    from paddle_tpu_torch.serving import PagedEngine, Request, make_trace

    trace = make_trace(seed=0, n_requests=24, mean_interarrival_steps=0.5,
                       prompt_len_choices=(24, 40, 57, 96),
                       new_tokens_choices=(128,), vocab_size=32000)
    spec_launches = None
    for leg, dtype in (("(a) parity, f32", torch.float32),
                       ("(b) speed, bf16", torch.bfloat16)):
        target, draft = spec_model(torch, dev, dtype)
        greedy, g_secs, _, _ = _serve_trace(torch, dev, target, trace)
        spec, s_secs, m, launches = _serve_trace(
            torch, dev, target, trace, draft_params=draft, spec_tokens=4)
        c = m["counters"]
        toks = sum(len(r.token_ids) for r in spec)
        equal = [x.token_ids == y.token_ids for x, y in zip(greedy, spec)]
        acc = c.get("draft_tokens_accepted", 0) / max(
            c.get("draft_tokens_proposed", 1), 1)
        log(f"[spec] {leg}: h2048, 16 layers, 4-layer draft, spec_tokens "
            f"4: greedy {toks / g_secs:.1f} tokens/s, speculative "
            f"{toks / s_secs:.1f} tokens/s, ratio {g_secs / s_secs:.3f} (the "
            f"reference's bar on its TPU was >= 1.5: recorded, not held); "
            f"acceptance rate {acc:.3f}, {c.get('spec_rounds', 0)} rounds, "
            f"{c.get('spec_pages_rewound', 0)} pages rewound; "
            f"{sum(equal)} of {len(equal)} requests equal to plain greedy; "
            f"launches {launches}")
        if not all(r.finished and len(r.token_ids) == r.max_new_tokens
                   for r in spec):
            raise AssertionError(f"spec {leg}: unfinished requests")
        if dtype == torch.float32 and not all(equal):
            first = equal.index(False)
            raise AssertionError(
                f"spec {leg}: speculative decoding broke greedy parity "
                f"(request {spec[first].request_id})")
        need = ("rms_norm_fwd", "decode_attention", "window_attention")
        if not all(launches[k] > 0 for k in need):
            raise AssertionError(f"spec {leg}: {need} not all launched: "
                                 f"{launches}")
        log(f"[spec] {leg}: the draft's decode steps launched B4 "
            f"{launches['decode_attention']} times on its "
            f"{b4_route(draft.dtype)}")
        spec_launches = launches
        del target, draft, greedy, spec
        torch.cuda.empty_cache()

    # (c) Llama-2-7B width
    draft = draft_from_params(model, 4)
    rng = np.random.default_rng(13)
    prompts = [rng.integers(1, model.args.vocab_size, size=n).astype(np.int32)
               for n in (40, 77, 130, 300)]
    kw = dict(max_slots=8, max_len=2048, page_size=16, min_bucket=16,
              device=dev)
    plain = PagedEngine(model, **kw)
    spec = PagedEngine(model, draft_params=draft, spec_tokens=4, **kw)

    def state(eng):
        return (tuple(tuple(row) for row in eng._bt),
                tuple(tuple(eng._alloc.refcount(pg) for pg in row)
                      for row in eng._bt),
                eng._alloc.free_count, eng._alloc.available,
                dict(eng._resv), eng._reserved_total)

    def held(what):
        if state(plain) != state(spec):
            raise AssertionError(f"spec 7B: after {what} the block tables, "
                                 "refcounts or reservations differ from a "
                                 "plain engine's at the same positions")

    rounds = rejected = 0
    agree = []
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        rp = plain.submit(Request(p, 32, request_id=i))
        rs = spec.submit(Request(p, 32, request_id=i))
        plain.step(), spec.step()                         # prefill
        held("a prefill")
        while not rs.finished:
            (committed,) = spec.step()["tokens"].values()
            rounds += 1
            rejected += len(committed) == 1
            while len(rp.token_ids) < len(rs.token_ids):
                plain.step()
            held(f"round {rounds} ({len(committed)} tokens committed)")
        agree.append(sum(a == b for a, b in zip(rp.token_ids, rs.token_ids))
                     / len(rs.token_ids))
    secs = time.perf_counter() - t0
    c = spec.metrics.summary()["counters"]
    acc = c.get("draft_tokens_accepted", 0) / max(
        c.get("draft_tokens_proposed", 1), 1)
    log(f"[spec] (c) Llama-2-7B width, 4-layer draft, 4 requests x 32 "
        f"tokens, one at a time, in {secs:.2f} s beside the plain engine: "
        f"{rounds} rounds, {rejected} of them rejecting every draft, "
        f"acceptance rate {acc:.3f}, "
        f"{c.get('spec_pages_rewound', 0)} pages rewound; block tables, "
        f"refcounts and reservations equal to the plain engine's after "
        f"every round; token agreement with plain greedy "
        f"{[round(a, 3) for a in agree]} (bf16: recorded)")
    if not (rejected > 0 and spec._alloc.pages_in_use == 0
            and c.get("spec_pages_rewound", 0) > 0):
        raise AssertionError("spec 7B: no all-rejected round, no page "
                             "rewound, or pages still held")
    return spec_launches


def phase_capacity(torch, dev, model, seed=0):
    """The reference's equal-KV-bytes leg at its TPU settings (bench.py
    `_bench_int8_kv_pool`): page size 64, max_len 1024, 24 slots, buckets
    from 64; 48 requests arriving 0.25 steps apart on average, prompts of
    192/256/320 tokens, 64 new tokens each. The model-dtype pool gets 48
    pages; the int8 pool the pages the same bytes buy. Each pool replays
    the trace once (nothing compiles, so nothing warms up). Returns the
    launch counts."""
    import numpy as np
    from paddle_tpu_torch.serving import PagedEngine, make_trace

    a = model.args
    ps, max_len, slots, base_pages, min_bucket = 64, 1024, 24, 48, 64
    trace = make_trace(seed=seed, n_requests=48, mean_interarrival_steps=0.25,
                       prompt_len_choices=(192, 256, 320),
                       new_tokens_choices=(64,), vocab_size=a.vocab_size)
    reset_launches()

    def run(num_pages, kv_dtype):
        eng = PagedEngine(model, max_slots=slots, max_len=max_len,
                          page_size=ps, num_pages=num_pages,
                          min_bucket=min_bucket, kv_dtype=kv_dtype,
                          device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        reqs = eng.replay(trace)
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        m = eng.metrics.summary()
        toks = sum(len(r.token_ids) for r in reqs)
        out = {"num_pages": num_pages,
               "kv_pool_bytes": int(m["gauges"]["kv_pool_bytes"]["value"]),
               "slots": int(m["gauges"]["active_slots"]["max"]),
               "tokens_per_s": toks / secs, "seconds": secs,
               "steps": eng.step_count}
        log(f"[capacity] {kv_dtype or str(model.dtype)} pool: {num_pages} "
            f"pages, {out['kv_pool_bytes'] / 2**30:.3f} GiB, sustained "
            f"slots {out['slots']}, {eng.step_count} steps, {toks} tokens "
            f"in {secs:.2f} s ({out['tokens_per_s']:.1f} tokens/s)")
        if not all(r.finished for r in reqs):
            raise AssertionError(f"capacity: unfinished requests "
                                 f"({kv_dtype})")
        return reqs, out

    base_reqs, base = run(base_pages, None)
    int8_page_bytes = 2 * a.num_layers * a.num_kv_heads * (ps * a.head_dim
                                                           + 4)
    int8_reqs, int8 = run(base["kv_pool_bytes"] // int8_page_bytes, "int8")
    ratio = int8["slots"] / max(base["slots"], 1)
    agreement = [float(np.mean(np.asarray(x.token_ids)
                               == np.asarray(y.token_ids)))
                 for x, y in zip(int8_reqs, base_reqs)]
    launches = launch_counts()
    log(f"[capacity] sustained-slot ratio {ratio:.3f} (bar 1.8), pool bytes "
        f"int8/model dtype {int8['kv_pool_bytes'] / base['kv_pool_bytes']:.4f}"
        f"; per-request top-1 agreement with the model-dtype pool: min "
        f"{min(agreement):.3f}, mean {float(np.mean(agreement)):.3f} "
        f"(random weights, free-running: recorded, not held); launches "
        f"{launches}")
    if not (ratio >= 1.8 and int8["kv_pool_bytes"] <= base["kv_pool_bytes"]):
        raise AssertionError(f"capacity: ratio {ratio}, bytes "
                             f"{int8['kv_pool_bytes']} vs "
                             f"{base['kv_pool_bytes']}")
    return launches


# ---------------------------------------------------------------------------
# disaggregated prefill/decode, and the router over three models
# ---------------------------------------------------------------------------


def _small_f32(torch, dev, model, layers=2):
    """The model's width in f32 with `layers` layers, drawn from seed 0."""
    from paddle_tpu_torch.models import Llama, init_params

    args = model.args._replace(num_layers=layers)
    gen_ = torch.Generator(device=dev).manual_seed(0)
    return Llama(args, init_params(args, gen_, device=dev,
                                   dtype=torch.float32))


def _watch_admissions(torch, worker, check=True):
    """Wrap `worker.admit_handoff` to record each hand-off's pages and its
    latency (send to seated, wall clock, exact; the registry keeps only
    bucketed quantiles) and, with `check`, to hold every shipped leaf bit
    for bit against what the pool holds under the slot's block table
    after the scatter (the check's own time is kept apart)."""
    from paddle_tpu_torch.serving.paged_engine import _leaves

    seen = {"pages": [], "latency_s": [], "check_s": 0.0}
    admit = worker.admit_handoff

    def watched(pkg):
        req = admit(pkg)
        torch.cuda.synchronize(worker.device)
        seen["latency_s"].append(time.time() - pkg.sent_at)
        seen["pages"].append(pkg.num_pages)
        if not check:
            return req
        t0 = time.perf_counter()
        slot = next(s for s in worker.slots.active_slots
                    if worker.slots.owner(s) is req)
        idx = torch.tensor(worker._bt[slot], dtype=torch.long,
                           device=worker.device)
        pool = _leaves(worker._pk) + _leaves(worker._pv)
        for shipped, held in zip(pkg._leaves(), pool):
            if not torch.equal(shipped.view(torch.uint8),       # the bits
                               held[:, idx].cpu().view(torch.uint8)):
                raise AssertionError(f"hand-off {pkg.request_id}: the pool "
                                     f"does not hold the shipped pages")
        seen["check_s"] += time.perf_counter() - t0
        return req

    worker.admit_handoff = watched
    return seen


def _pack_scatter(pm, dm):
    """The prefill side's pack (serialise, the D2H copy included) and the
    decode side's scatter times: mean and max (exact in the registry)."""
    pk, sc = pm.observation("handoff_pack_s"), dm.observation("page_scatter_s")
    return (f"pack mean {pk['mean'] * 1e3:.1f} max {pk['max'] * 1e3:.1f} ms, "
            f"scatter mean {sc['mean'] * 1e3:.1f} max "
            f"{sc['max'] * 1e3:.1f} ms")


def _ms(xs):
    """Median and max of seconds, in ms, for a log line."""
    return (f"median {statistics.median(xs) * 1e3:.1f} ms, max "
            f"{max(xs) * 1e3:.1f} ms")


def _drained(label, *workers):
    for w in workers:
        if w._alloc.pages_in_use or w._reserved_total or \
                w.slots.free_count != w.max_slots:
            raise AssertionError(f"{label}: {type(w).__name__} did not drain: "
                                 f"{w._alloc.pages_in_use} pages in use, "
                                 f"{w._reserved_total} reserved")


def _serve_tokens(eng, prompts, new_tokens):
    from paddle_tpu_torch.serving import Request

    reqs = [Request(p, new_tokens, request_id=i)
            for i, p in enumerate(prompts)]
    eng.serve(reqs)
    return [list(r.token_ids) for r in reqs]


DISAGG_LEG = dict(max_slots=8, max_len=2048, page_size=64, min_bucket=64)


def phase_disagg(torch, dev, model, mono_reqs, new_tokens=64):
    """Disaggregated serving on the 7B model. (a) bf16, 32 layers: the
    engine phase's 12 requests through `DisaggServer` over
    `LocalTransport` at the engine's settings: every shipped page equals
    what the decode pool holds after the scatter, bit for bit; first
    tokens equal the monolithic engine's; both workers drain. Token
    agreement with the monolithic run is recorded (bf16 rows decoded in
    other batches may round otherwise). (b) f32, 2 layers at 7B width:
    greedy, over the int8 pool, and chunked (256): tokens equal to the
    monolithic `PagedEngine`'s, request for request. (c) bench.py's disagg
    leg at its TPU settings (:1133-1145): the steady stream's tokens per
    scheduler step through a 4 x 1536-token burst within 0.9-1.1 of its
    base (held), the monolithic counterfactual, hand-off MB and latency,
    decode step ms and tokens/s (recorded). Returns (a)'s launch counts."""
    from paddle_tpu_torch.serving import DisaggServer, PagedEngine, Request

    srv = DisaggServer(model, max_slots=8, max_len=2048, page_size=16,
                       min_bucket=16, device=dev)
    seen = _watch_admissions(torch, srv.decode)
    traffic = engine_traffic(model.args.vocab_size)
    reqs = [Request(t.pop("prompt"), new_tokens, request_id=i, **t)
            for i, t in enumerate(traffic)]
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    srv.serve(reqs)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    n_tok = sum(len(r.token_ids) for r in reqs)
    firsts = [r.token_ids[0] for r in reqs] == \
        [r.token_ids[0] for r in mono_reqs]
    same = sum(r.token_ids == m.token_ids for r, m in zip(reqs, mono_reqs))
    pos_agree = sum(a == b for r, m in zip(reqs, mono_reqs)
                    for a, b in zip(r.token_ids, m.token_ids))
    pm = srv.prefill.metrics
    served = secs - seen["check_s"]
    log(f"[disagg] (a) bf16: {len(reqs)} requests, {n_tok} tokens in "
        f"{served:.2f} s without the page checks' {seen['check_s']:.2f} s "
        f"({n_tok / served:.1f} tokens/s); {len(seen['pages'])} hand-offs, "
        f"{sum(seen['pages'])} pages, "
        f"{pm.counter('handoff_bytes') / 1e6:.1f} MB, each page bit-identical "
        f"in the decode pool; latency {_ms(seen['latency_s'])}, "
        f"{_pack_scatter(pm, srv.decode.metrics)}; "
        f"first tokens equal to the monolithic "
        f"engine's: {firsts}; agreement with it (recorded): {same}/"
        f"{len(reqs)} requests, {pos_agree}/{n_tok} positions; launches "
        f"{launches}")
    _drained("disagg (a)", srv.prefill, srv.decode)
    if not (firsts and len(seen["pages"]) == len(reqs)
            and all(r.finished and len(r.token_ids) == new_tokens
                    for r in reqs)
            and launches["paged_decode_attention"] > 0
            and launches["window_attention"] > 0):
        raise AssertionError("disagg (a) failed")
    srv = None
    torch.cuda.empty_cache()

    small = _small_f32(torch, dev, model)
    greedy = [t["prompt"] for t in engine_traffic(model.args.vocab_size)]
    for label, kw in (("greedy", {}), ("int8 pool", {"kv_dtype": "int8"}),
                      ("chunked 256", {"prefill_chunk": 256})):
        kw = dict(max_slots=8, max_len=2048, page_size=16, min_bucket=16,
                  device=dev, **kw)
        mono = _serve_tokens(PagedEngine(small, **kw), greedy, 32)
        dis = _serve_tokens(DisaggServer(small, **kw), greedy, 32)
        equal = sum(a == b for a, b in zip(dis, mono))
        log(f"[disagg] (b) f32, 2 layers, {label}: {equal}/{len(mono)} "
            f"requests token for token equal to the monolithic engine")
        if equal != len(mono):
            raise AssertionError(f"disagg (b) {label}: {equal}/{len(mono)}")
    small = None
    torch.cuda.empty_cache()
    disagg_bench_leg(torch, dev, model)
    return launches


def disagg_bench_leg(torch, dev, model, chunk=256, steady_len=128,
                     steady_new=256, burst_len=1536, burst_new=16, win=20,
                     seed=0):
    """bench.py `_bench_serving_disagg`'s leg 1 at its TPU settings on
    `model`; holds the steady stream's rate ratio, records the rest."""
    import numpy as np
    from paddle_tpu_torch.serving import (DecodeWorker, LocalTransport,
                                          PagedEngine, PrefillWorker, Request)

    rng = np.random.default_rng(seed)

    def prompt(n):
        return rng.integers(1, model.args.vocab_size, n).astype(np.int32)

    steady_prompt = prompt(steady_len)
    burst = [prompt(burst_len) for _ in range(4)]
    lt = LocalTransport()
    pw = PrefillWorker(model, transport=lt, prefill_chunk=chunk, device=dev,
                       **DISAGG_LEG)
    done = {}
    dw = DecodeWorker(model, transport=lt, device=dev,
                      completion_cb=lambda r: done.setdefault(
                          r.request_id, len(r.token_ids)), **DISAGG_LEG)
    seen = _watch_admissions(torch, dw, check=False)

    def pw_drain():
        while pw.queue or pw.slots.active_slots or pw._chunk_streams:
            pw.step()

    pw.submit(Request(prompt(burst_len), 4, request_id="warm"))
    pw_drain()
    while "warm" not in done:
        dw.step()
    pw.submit(Request(steady_prompt, steady_new, request_id="steady"))
    pw_drain()
    while not dw.slots.active_slots:
        dw.step()
    for _ in range(6):
        dw.step()
    steady = next(dw.slots.owner(s) for s in dw.slots.active_slots
                  if dw.slots.owner(s).request_id == "steady")

    def window(burst_active=False):
        n0, times = len(steady.token_ids), []
        for _ in range(win):
            if burst_active and (pw.queue or pw.slots.active_slots
                                 or pw._chunk_streams):
                pw.step()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            dw.step()
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        return (len(steady.token_ids) - n0) / win, times

    base_rate, base_t = window()
    for i, p in enumerate(burst):
        pw.submit(Request(p, burst_new, request_id=f"burst{i}"))
    burst_rate, burst_t = window(burst_active=True)
    pw_drain()
    t0, n0 = time.perf_counter(), sum(done.values())
    while len(done) < 6:
        dw.step()
    torch.cuda.synchronize(dev)
    decode_tps = (sum(done.values()) - n0) / (time.perf_counter() - t0)
    ratio = burst_rate / base_rate
    reg = dw.metrics.registry
    pk = pw.metrics.observation("handoff_pack_s")
    sc = dw.metrics.observation("page_scatter_s")
    stats = {
        "handoffs": dw.metrics.counter("handoffs_admitted"),
        "handoff_mb": pw.metrics.counter("handoff_bytes") / 1e6,
        "handoff_pages": seen["pages"],
        "handoff_latency_ms": [x * 1e3 for x in seen["latency_s"]],
        "registry_latency_ms_p50": reg.quantile("handoff_latency_s", 0.5)
        * 1e3,
        "registry_latency_ms_p99": reg.quantile("handoff_latency_s", 0.99)
        * 1e3,
        "pack_ms_mean": pk["mean"] * 1e3, "pack_ms_max": pk["max"] * 1e3,
        "scatter_ms_mean": sc["mean"] * 1e3,
        "scatter_ms_max": sc["max"] * 1e3,
        "decode_step_ms_base_min": min(base_t) * 1e3,
        "decode_step_ms_burst_min": min(burst_t) * 1e3,
        "decode_step_ms_base_median": statistics.median(base_t) * 1e3,
        "decode_step_ms_burst_median": statistics.median(burst_t) * 1e3,
        "steady_tokens_per_step_base": base_rate,
        "steady_tokens_per_step_burst": burst_rate,
        "decode_tokens_per_s": decode_tps}
    _drained("disagg (c)", pw, dw)
    pw = dw = lt = None
    torch.cuda.empty_cache()
    mono = PagedEngine(model, prefill_chunk=chunk, device=dev, **DISAGG_LEG)
    s = mono.submit(Request(steady_prompt, steady_new, request_id="steady"))
    while not mono.slots.active_slots:
        mono.step()
    for _ in range(6):
        mono.step()
    for i, p in enumerate(burst):
        mono.submit(Request(p, burst_new, request_id=f"burst{i}"))
    n0 = len(s.token_ids)
    for _ in range(win):
        mono.step()
    stats["monolithic_steady_tokens_per_step"] = (len(s.token_ids) - n0) / win
    mono = None
    torch.cuda.empty_cache()
    log(f"[disagg] (c) bench leg: steady tokens/step {base_rate:.3f} base, "
        f"{burst_rate:.3f} under the burst: ratio {ratio:.3f} (bar 0.9-1.1); "
        f"DISAGG_LEG {json.dumps(stats)}")
    if not 0.9 <= ratio <= 1.1:
        raise AssertionError(f"disagg (c): steady rate ratio {ratio}")


def router_trace(vocab, gpt_vocab, bert_vocab, llama_new=32, gpt_new=32,
                 scale=16, seed=0):
    """bench.py `_bench_router_trace` (:1303-1321): three tenants, both SLO
    classes, its arrival steps and model mix; prompts `scale` times its
    lengths (Llama 192-272 tokens, GPT 144-192, BERT 160-208)."""
    import numpy as np

    rng = np.random.default_rng(seed + 1)
    tenants = ("acme", "globex", "initech")

    def u(hi, n):
        return rng.integers(1, hi, n * scale).astype(np.int32)

    trace = [{"model": "llama", "arrival_step": i, "prompt": u(vocab, 12 + i),
              "max_new_tokens": llama_new, "tenant": tenants[i % 3],
              "slo": "interactive" if i % 2 == 0 else "batch"}
             for i in range(6)]
    trace += [{"model": "gpt", "arrival_step": 2 * i + 1,
               "prompt": u(gpt_vocab, 9 + i), "max_new_tokens": gpt_new,
               "tenant": tenants[i % 3], "slo": "interactive"}
              for i in range(4)]
    trace += [{"model": "bert", "arrival_step": 3 * i,
               "prompt": u(bert_vocab, 10 + i),
               "tenant": tenants[(i + 1) % 3], "slo": "batch"}
              for i in range(4)]
    return trace


def gpt_reference_logits(torch, model, ids):
    """Plain full-sequence GPT-2 forward with no cache, in f32 from the
    model's weights, sharing no code with the port (LayerNorm, exact GELU
    and causal attention written here): logits [T, vocab] f32."""
    a = model.args
    T, nh, hd = ids.shape[0], a.num_heads, a.head_dim

    def ln(x, w, b):
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + a.ln_eps) * w.float() + b.float()

    h = (model.word_emb[ids.long()] + model.pos_emb[:T]).float()
    for i in range(a.num_layers):
        lp = {k: v.float() for k, v in model.layer(i).items()}
        x = ln(h, lp["ln1_w"], lp["ln1_b"])
        q, k, v = ((x @ lp[w] + lp[b]).view(T, nh, hd)
                   for w, b in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")))
        o = _attention(torch, q, k, v).reshape(T, -1)
        h = h + o @ lp["wo"] + lp["bo"]
        x = ln(h, lp["ln2_w"], lp["ln2_b"])
        f = x @ lp["fc1_w"] + lp["fc1_b"]
        f = 0.5 * f * (1.0 + torch.erf(f / math.sqrt(2.0)))
        h = h + f @ lp["fc2_w"] + lp["fc2_b"]
    h = ln(h, model.lnf_w, model.lnf_b)
    return h @ model.word_emb.float().t()


def gpt_cached_logits(torch, dev, model, req):
    """The request's prompt + generated tokens, teacher-forced through the
    port's cached forward (prefill, then one decode step a token at per-row
    positions): next-token logits [m, vocab] f32 of positions n-1 ..
    n+m-2."""
    import numpy as np
    from paddle_tpu_torch.models import gpt as gpt_m

    n, toks = req.prompt_ids.size, list(req.token_ids)
    ck, cv = gpt_m.gpt_cache(model, 1, n + len(toks))
    rows = [gpt_m._gpt_forward_cached(
        model, torch.from_numpy(req.prompt_ids[None]).to(dev), ck, cv, 0)[0]]
    for i, t in enumerate(toks[:-1]):
        rows.append(gpt_m._gpt_forward_cached(
            model, torch.tensor([[t]], device=dev), ck, cv,
            torch.tensor([n + i], dtype=torch.int32, device=dev))[0])
    return torch.cat(rows)


def _f32_copy(cls, model, cfg):
    """The same weights in f32 (a Gpt or Bert)."""
    tree = {k: v.float() for k, v in model.named_parameters()
            if not k.startswith("layers.")}
    tree["layers"] = {k: v.float() for k, v in model.layers.items()}
    return cls(cfg, tree, device=model.device)


def phase_router(torch, dev, model, gpt_cfg=None, bert_cfg=None, seed=0):
    """One `Router` over three backends on the card: the 7B `PagedEngine`
    (bf16, 2 slots, max_len 1024, pages of 16: an interactive arrival must
    preempt a batch slot), GPT-2 small (`GPTConfig()`, bf16, `GptEngine`,
    4 slots, max_len 1024) and BERT-base (`BertConfig()`, bf16,
    `BertBackend`, batch 8), on `router_trace`. Holds: every request
    finishes; router_preemptions >= 1 and equal to router_resumes; B4 and
    B5 launch (and nothing else) while GPT-2 serves alone; GPT-2 in f32
    (`GptEngine`) gives `gpt_generate`'s tokens for 4 prompts; GPT-2's bf16
    logits within rel 0.10, top-1 0.80 of a plain f32 forward
    (`gpt_reference_logits`); BERT-base's bf16 pooled output within rel
    0.05 of the f32 forward of its weights; in f32 at 7B width, 2 layers, a
    request the router preempted and resumed gives its uninterrupted
    tokens. Records tokens/s per model, TTFT p50 per model and SLO class,
    BERT's embed step at batch 8, the per-tenant counters. Returns the
    launch counts of the bf16 runs: GPT-2 alone and the router's."""
    import numpy as np
    from paddle_tpu_torch.models import (Bert, BertConfig, Gpt, GPTConfig,
                                         GPTGenArgs, gpt_generate)
    from paddle_tpu_torch.serving import (BertBackend, GptEngine,
                                          PagedEngine, Request, Router)

    gcfg, bcfg = gpt_cfg or GPTConfig(), bert_cfg or BertConfig()
    gargs = GPTGenArgs.from_config(gcfg)
    bf16 = torch.bfloat16
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    gpt = Gpt(gargs, device=dev, dtype=bf16, generator=gen_)
    bert = Bert(bcfg, device=dev, dtype=bf16, generator=gen_)
    rng = np.random.default_rng(seed + 7)

    # GPT-2 alone: short prompts prefill through B5, decode through B4
    short = [rng.integers(1, gcfg.vocab_size, n).astype(np.int32)
             for n in (16, 40, 64, 24)]
    eng = GptEngine(gpt, max_slots=4, max_len=1024, device=dev)
    torch.cuda.synchronize(dev)
    reset_launches()
    greqs = eng.serve([Request(p, 32) for p in short])
    torch.cuda.synchronize(dev)
    alone = launch_counts()
    log(f"[router] GPT-2 alone (bf16, 4 prompts of {[p.size for p in short]}"
        f" tokens, 32 new): launches {alone}")
    others = {k: v for k, v in alone.items()
              if v and k not in ("decode_attention", "window_attention")}
    if not (alone["decode_attention"] > 0 and alone["window_attention"] > 0
            and not others):
        raise AssertionError(f"GPT-2 alone did not run B4 and B5 only: "
                             f"{alone}")
    ref = gpt_reference_logits(torch, gpt, forward_ids(torch, dev, greqs[2]))
    n = greqs[2].prompt_ids.size
    compare(torch, "router", f"GPT-2 bf16 cached logits vs the f32 forward, "
            f"after a {n}-token prompt",
            gpt_cached_logits(torch, dev, gpt, greqs[2]),
            ref[n - 1:n - 1 + len(greqs[2].token_ids)],
            LOGIT_BARS["bfloat16"])
    g32 = _f32_copy(Gpt, gpt, gargs)
    e32 = GptEngine(g32, max_slots=4, max_len=1024, device=dev)
    r32 = e32.serve([Request(p, 32) for p in short])
    equal = sum(list(r.token_ids) == gpt_generate(
        g32, p[None], max_new_tokens=32, device=dev)[0, p.size:].tolist()
        for p, r in zip(short, r32))
    log(f"[router] GPT-2 f32: GptEngine equal to gpt_generate for "
        f"{equal}/{len(short)} prompts")
    if equal != len(short):
        raise AssertionError(f"GPT-2 f32 GptEngine vs gpt_generate: {equal}")
    eng = e32 = g32 = None

    # BERT-base: bf16 pooled output against the f32 forward; embed step ms
    be = BertBackend(bert, max_batch=8, device=dev)
    lens = [int(x) for x in rng.integers(160, 209, 8)]
    prompts = [rng.integers(1, bcfg.vocab_size, k).astype(np.int32)
               for k in lens]
    step_ms = []
    for _ in range(6):
        reqs = [be.submit(p) for p in prompts]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        be.step()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    got = torch.from_numpy(np.stack([r.embedding for r in reqs]))
    ids = torch.zeros(8, max(lens), dtype=torch.long)
    mask = torch.zeros_like(ids)
    for i, p in enumerate(prompts):
        ids[i, :p.size] = torch.from_numpy(p)
        mask[i, :p.size] = 1
    b32 = _f32_copy(Bert, bert, bcfg)
    ref = b32(ids.to(dev), mask.to(dev))[1].cpu()
    rel = ((got - ref).norm() / ref.norm()).item()
    log(f"[router] BERT-base bf16 pooled vs f32 forward: rel {rel:.3e} (bar "
        f"0.05); embed step at batch 8 (lengths {min(lens)}-{max(lens)}): "
        f"median {statistics.median(step_ms[1:]):.2f} ms of "
        f"{[round(x, 2) for x in step_ms[1:]]}")
    if not (math.isfinite(rel) and rel <= 0.05):
        raise AssertionError(f"BERT-base bf16 pooled rel {rel}")
    b32 = be = None

    # the router
    router = Router({
        "llama": PagedEngine(model, max_slots=2, max_len=1024, page_size=16,
                             device=dev),
        "gpt": GptEngine(gpt, max_slots=4, max_len=1024, device=dev),
        "bert": BertBackend(bert, max_batch=8, device=dev)})
    trace = router_trace(model.args.vocab_size, gcfg.vocab_size,
                         bcfg.vocab_size)
    torch.cuda.synchronize(dev)
    reset_launches()
    t0 = time.perf_counter()
    out = router.replay(trace)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = launch_counts()
    snap = router.metrics.registry.snapshot()["counters"]

    def by(name, key):
        tot = {}
        for labels, v in snap.get(name, {}).items():
            part = dict(kv.split("=") for kv in labels.split(","))
            tot[part[key]] = tot.get(part[key], 0) + v
        return tot

    pre = sum(snap.get("router_preemptions", {}).values())
    res = sum(snap.get("router_resumes", {}).values())
    tokens = by("router_tokens", "model")
    ttft = {}
    for t, r in zip(trace, out):
        ttft.setdefault(f"{t['model']}/{t['slo']}", []).append(r.ttft_s)
    embeds = by("router_completed", "model").get("bert", 0)
    stats = {"seconds": secs, "router_steps": router.step_count,
             "tokens_per_s": {m: v / secs for m, v in tokens.items()
                              if m != "bert"},
             "bert_embeddings_per_s": embeds / secs,
             "ttft_ms_p50": {k: statistics.median(v) * 1e3
                             for k, v in ttft.items()},
             "preemptions": pre, "resumes": res,
             "completed_by_tenant": by("router_completed", "tenant"),
             "tokens_by_tenant": by("router_tokens", "tenant"),
             "embed_step_ms_batch8": statistics.median(step_ms[1:])}
    log(f"[router] {len(trace)} requests in {secs:.2f} s, "
        f"{router.step_count} router steps; ROUTER {json.dumps(stats)}; "
        f"launches {launches}")
    if not (all(r.finished for r in out) and pre >= 1 and pre == res):
        raise AssertionError(f"router: finished "
                             f"{sum(r.finished for r in out)}/{len(out)}, "
                             f"preemptions {pre}, resumes {res}")
    router = gpt = bert = None
    torch.cuda.empty_cache()
    _add(launches, alone)

    # f32, 7B width, 2 layers: preempted and resumed = uninterrupted
    small = _small_f32(torch, dev, model)
    p_batch, p_inter = (rng.integers(1, model.args.vocab_size, k)
                        .astype(np.int32) for k in (192, 208))
    kw = dict(max_slots=1, max_len=1024, page_size=16, device=dev)
    ref = PagedEngine(small, **kw).serve([Request(p_batch, 32)])[0]
    eng = PagedEngine(small, **kw)
    router = Router({"llama": eng})
    victim = router.submit("llama", p_batch, slo="batch", tenant="nightly",
                           max_new_tokens=32)
    for _ in range(6):
        router.step()
    router.submit("llama", p_inter, tenant="acme", max_new_tokens=8)
    router.run_until_idle()
    reg = router.metrics.registry
    labels = {"model": "llama", "tenant": "nightly"}
    ok = (list(victim.token_ids) == list(ref.token_ids)
          and reg.counter("router_preemptions", labels=labels) == 1
          and reg.counter("router_resumes", labels=labels) == 1)
    log(f"[router] f32 at 7B width, 2 layers: the preempted and resumed "
        f"request gives its uninterrupted tokens: {ok}")
    _drained("router f32", eng)
    if not ok:
        raise AssertionError("router f32 preempt/resume parity failed")
    return launches


# ---------------------------------------------------------------------------
# c2: a row's bf16 result independent of its batch (B4-B8); c3: B10 on two
# streams
# ---------------------------------------------------------------------------

# (label, nh, nkv, hd, cache length, the probed row's pos, the other rows'
# pos): Llama-2-7B's decode and GPT-2's in the router (12 kv heads). The
# other rows are shorter and longer than the probed one; at 7B width all
# under 1024 keys, where the bound on pos used to cut every row's keys
# over 1 split and the row alone over 2
C2_SHAPES = (("7B decode", 32, 32, 128, 2048, 600,
              (50, 200, 800, 950, 1000, 10, 400)),
             ("GPT-2 decode", 12, 12, 64, 1024, 700,
              (30, 150, 1000, 400, 90, 1023, 5)))
# where the probed row sits in the batches of 8 and of 3 rows
C2_AT = {8: 3, 3: 1}
C2_PS = 16
C2_WINDOW = 16        # B5's window: a paged-prefill suffix
# B8's GEMV: the probed x row among M rows, at row C2_GEMV_AT[M]
C2_GEMV_AT = {1: 0, 8: 3, 9: 8, 16: 15}


def _c2_rows(torch, dev, nh, nkv, hd, length, n, seed):
    """n rows' bf16 q [n, 1, nh, hd], window q [n, C2_WINDOW, nh, hd],
    caches [n, nkv, length, hd] and int8 pages (codes, scales): each row
    its own seed, so a row holds the same values in any batch."""
    rows = []
    for i in range(n):
        g = torch.Generator(device=dev).manual_seed(seed + 1000 * i)
        k = torch.randn(nkv, length, hd, generator=g, device=dev).bfloat16()
        v = torch.randn(nkv, length, hd, generator=g, device=dev).bfloat16()
        q = torch.randn(1, nh, hd, generator=g, device=dev).bfloat16()
        qw = torch.randn(C2_WINDOW, nh, hd, generator=g,
                         device=dev).bfloat16()
        pages = length // C2_PS
        codes = [torch.randint(-127, 128, (pages, nkv, C2_PS, hd),
                               generator=g, device=dev, dtype=torch.int8)
                 for _ in range(2)]
        scales = [torch.rand(pages, nkv, generator=g, device=dev) * 2 + 0.5
                  for _ in range(2)]
        rows.append((q, qw, k, v, codes, scales))
    return rows


def _c2_batch(torch, dev, rows, pos, nkv, hd, length):
    """The rows as one batch: q, window q, contiguous caches, bf16 and int8
    pools (page 0 the null page, a row's pages in order) with their block
    tables, and pos."""
    b = len(rows)
    pages = length // C2_PS
    q = torch.stack([r[0] for r in rows])
    qw = torch.stack([r[1] for r in rows])
    ck = torch.stack([r[2] for r in rows])
    cv = torch.stack([r[3] for r in rows])

    def pool(c):   # [b, nkv, len, hd] -> [1 + b * pages, nkv, ps, hd]
        body = c.reshape(b, nkv, pages, C2_PS, hd).transpose(1, 2).reshape(
            b * pages, nkv, C2_PS, hd)
        return torch.cat([torch.zeros_like(body[:1]), body]).contiguous()

    def stacked(i):   # the int8 codes / scales of half i, page 0 null
        codes = torch.cat([torch.zeros_like(rows[0][4][i][:1])]
                          + [r[4][i] for r in rows]).contiguous()
        scales = torch.cat([torch.ones_like(rows[0][5][i][:1])]
                           + [r[5][i] for r in rows]).contiguous()
        return codes, scales

    bt = (torch.arange(b * pages, dtype=torch.int32, device=dev)
          .reshape(b, pages) + 1).contiguous()
    (kq, ks), (vq, vs) = stacked(0), stacked(1)
    return dict(q=q, qw=qw, ck=ck, cv=cv, pk=pool(ck), pv=pool(cv), kq=kq,
                vq=vq, ks=ks, vs=vs, bt=bt,
                pos=torch.tensor(pos, dtype=torch.int32))


def _c2_outputs(torch, at, d, bound, max_pos):
    """Each of B4-B7's bf16 output for batch `d`. bound: the host knows
    every row's pos (a CPU tensor, and max_pos for B6/B7) or only that
    they are on the card (max_pos None)."""
    pos = d["pos"] if bound else d["pos"].to(d["q"].device)
    return {
        "B4": at.decode_attention(d["q"], d["ck"], d["cv"], pos),
        "B5": at.window_attention(d["qw"], d["ck"], d["cv"], pos),
        "B6": at.paged_decode_attention(d["q"], d["pk"], d["pv"], d["bt"],
                                        pos, max_pos=max_pos),
        "B7": at.paged_decode_attention(d["q"], d["kq"], d["vq"], d["bt"],
                                        pos, k_scale=d["ks"], v_scale=d["vs"],
                                        max_pos=max_pos)}


def phase_c2(torch, dev, check=True):
    """Fault C2: one row through each bf16 kernel in three batches, alone
    (b = 1, its own pos as the bound), among 7 rows shorter and longer
    (the batch's largest pos as max_pos, pos known to the host) and among 3
    rows with max_pos=None (pos on the card): B4, B5, B6 and B7 must give
    the row bit-identical outputs. B8's GEMV: one x row at M = 1, 8, 9 and
    16 at the four decode shapes, bit-identical. With check=False (a
    record of a tree before the repair) it only prints which differ. The
    disagg phase prints the agreement of whole requests."""
    from paddle_tpu_torch.kernels import attention as at
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    differ = []
    for label, nh, nkv, hd, length, pos0, others in C2_SHAPES:
        rows = _c2_rows(torch, dev, nh, nkv, hd, length, 1 + len(others),
                        seed=11)
        target, rest = rows[0], rows[1:]
        alone = _c2_outputs(torch, at, _c2_batch(
            torch, dev, [target], [pos0], nkv, hd, length), True, pos0)
        results = {k: [] for k in alone}
        for b, bound in ((8, True), (3, False)):
            at_i = C2_AT[b]
            brows = rest[:at_i] + [target] + rest[at_i:b - 1]
            bpos = list(others[:at_i]) + [pos0] + list(others[at_i:b - 1])
            outs = _c2_outputs(torch, at, _c2_batch(
                torch, dev, brows, bpos, nkv, hd, length), bound,
                max(bpos) if bound else None)
            for k, out in outs.items():
                results[k].append(torch.equal(out[at_i], alone[k][0]))
        torch.cuda.synchronize()
        for k, same in results.items():
            log(f"[c2] {k} bf16 {label} (nh={nh} nkv={nkv} hd={hd} "
                f"len={length}), a row at pos {pos0}: among 7 rows with "
                f"max_pos {'the same bits' if same[0] else 'DIFFERENT'}, "
                f"among 3 rows with pos on the card "
                f"{'the same bits' if same[1] else 'DIFFERENT'} as alone")
            if not all(same):
                differ.append(f"{k} {label}")
        del rows, target, rest, alone
    for k, n, _ in DECODE_MATMULS:
        x0, w, s = matmul_case(torch, dev, torch.bfloat16, 1, k, n, seed=21)
        ref = qm.weight_only_matmul(x0, w, s)
        same = {}
        for m, row in C2_GEMV_AT.items():
            g = torch.Generator(device=dev).manual_seed(m)
            x = torch.randn(m, k, generator=g, device=dev).bfloat16()
            x[row] = x0[0]
            same[m] = torch.equal(qm.weight_only_matmul(x, w, s)[row],
                                  ref[0])
        log(f"[c2] B8 GEMV bf16 K={k} N={n}, one x row at M = 1, 8, 9, 16: "
            + ", ".join(f"M={m} {'the same bits' if v else 'DIFFERENT'}"
                        for m, v in same.items()))
        if not all(same.values()):
            differ.append(f"B8 GEMV K={k} N={n}")
    log(f"[c2] rows whose bf16 output depends on their batch: "
        f"{differ or 'none'}")
    if check and differ:
        raise AssertionError(f"fault C2: a row's output depends on its "
                             f"batch in {differ}")
    return differ


# B10's rows on the two streams: the 7B micro-batch (132 blocks, one an
# SM: two calls barely overlap) and 64 rows (32 blocks in 8 clusters: two
# calls fit on the card at once)
C3_ROWS = (4096, 64)


def phase_c3(torch, dev, check=True, calls=64):
    """Fault C3: B10 on two streams of one card at once, different inputs
    (two seeds, [rows, 4096] bf16 for each of C3_ROWS), `calls` calls
    each, interleaved: every call must give the bits it gives alone on the
    default stream. With check=False it only prints."""
    from paddle_tpu_torch.kernels import rms_norm as rn

    bad = {}
    for rows in C3_ROWS:
        ins = []
        for seed in (6, 60):
            x, w, g = rms_case(torch, dev, rows, 4096, torch.bfloat16,
                               seed=seed)
            _, r = rn.rms_norm_fwd(x, w, RMS_EPS)
            ins.append((x, w, r, g))
        solo = [rn.rms_norm_bwd(*a) for a in ins]
        torch.cuda.synchronize(dev)
        streams = [torch.cuda.Stream(dev) for _ in ins]
        for st in streams:
            st.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(st):
                # hold both streams while the host enqueues every call, so
                # that the two streams' calls are queued when they start
                torch.cuda._sleep(20_000_000)
        outs = [[], []]
        for _ in range(calls):
            for i, (st, a) in enumerate(zip(streams, ins)):
                with torch.cuda.stream(st):
                    outs[i].append(rn.rms_norm_bwd(*a))
        torch.cuda.synchronize(dev)
        bad[rows] = [(i, j) for i in range(2)
                     for j, (dx, dw) in enumerate(outs[i])
                     if not (torch.equal(dx, solo[i][0])
                             and torch.equal(dw, solo[i][1]))]
        log(f"[c3] B10 [{rows}, 4096] bf16 on two streams, {calls} calls "
            f"each, interleaved: {2 * calls - len(bad[rows])} of "
            f"{2 * calls} calls give their solo bits"
            + (f"; the rest differ: {bad[rows][:8]}" if bad[rows] else ""))
    if check and any(bad.values()):
        raise AssertionError(f"fault C3: B10 calls on two streams differ "
                             f"from their solo bits: {bad}")
    return bad


# ---------------------------------------------------------------------------
# tune: the block tuner on B8's tile
# ---------------------------------------------------------------------------

TUNE_SHAPES = ((2048, 4096, 11008), (8192, 4096, 11008))


def phase_tune(torch, dev):
    """The block tuner on B8's tile, on an empty cache in a temporary
    directory: with PADDLE_KERNEL_AUTOTUNE=1 a call at M = 2048 and 8192,
    K = 4096, N = 11008 measures the three TILES candidates
    (`kernels/timing.py`); a second call is a cache hit, and another after
    the in-process mirror is dropped reads the disk; PADDLE_TUNE_BLOCKS
    overrides both; the output under each pick within B8's bar of its
    plain version. The registry's lookup counter says where each pick came
    from."""
    import os
    import shutil
    import tempfile

    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.kernels import tuning
    from paddle_tpu_torch.observability import (MetricsRegistry,
                                                set_global_registry)

    env = ("PADDLE_TUNING_CACHE", "PADDLE_KERNEL_AUTOTUNE",
           "PADDLE_TUNE_BLOCKS")
    saved = {k: os.environ.get(k) for k in env}
    tmp = tempfile.mkdtemp(prefix="tune_")
    reg = MetricsRegistry()
    prev = set_global_registry(reg)
    try:
        os.environ["PADDLE_TUNING_CACHE"] = os.path.join(tmp, "tuning.json")
        os.environ["PADDLE_KERNEL_AUTOTUNE"] = "1"
        os.environ.pop("PADDLE_TUNE_BLOCKS", None)
        tuning.clear_memory_cache()

        def picked():
            g = reg.snapshot()["gauges"]["kernel_block"]
            return (g["kernel=b8_tile,param=tile_m"]["value"],
                    g["kernel=b8_tile,param=tile_n"]["value"])

        def source():
            c = reg.snapshot()["counters"].get("kernel_tuning_lookups", {})
            return {k.split("source=")[1]: v for k, v in c.items()
                    if "kernel=b8_tile" in k}

        for m, k, n in TUNE_SHAPES:
            x, w, s = matmul_case(torch, dev, torch.bfloat16, m, k, n)
            plain = qm.dequant_matmul_plain(x, w, s)
            tol = TOL["bfloat16"] * max(1.0, plain.float().abs().max().item())
            rule = qm.tile(m, n, qm._sms(dev))
            steps = []
            for what in ("measured", "cache", "disk", "env"):
                before = dict(source())
                if what == "disk":
                    tuning.clear_memory_cache()
                if what == "env":
                    os.environ["PADDLE_TUNE_BLOCKS"] = json.dumps(
                        {"b8_tile": {"tile_m": 128, "tile_n": 128}})
                out = qm.weight_only_matmul(x, w, s)
                torch.cuda.synchronize(dev)
                err = (out.float() - plain.float()).abs().max().item()
                after = source()
                got = [src for src in after if after[src] != before.get(src)]
                steps.append((what, picked(), got, err))
                if not (math.isfinite(err) and err <= tol):
                    raise AssertionError(f"tune: B8 at M={m} under tile "
                                         f"{picked()}: {err} > {tol}")
            os.environ.pop("PADDLE_TUNE_BLOCKS", None)
            times = {lbl.split("candidate=")[1].split(",kernel=")[0]:
                     v["value"] * 1e3
                     for lbl, v in reg.snapshot()["gauges"][
                         "kernel_tuning_seconds"].items()
                     if f"m={tuning.bucket(m)}," in lbl}
            log(f"[tune] B8 M={m} K={k} N={n}: the rule's tile {rule}; "
                f"measured (ms) {times}; "
                + "; ".join(f"{what}: tile {t} from {g}, max_abs_err "
                            f"{e:.3e} (bar {tol:.3e})"
                            for what, t, g, e in steps))
            want = ["measured", "cache", "cache", "env"]
            if [g for _, _, g, _ in steps] != [[w_] for w_ in want] or \
                    steps[3][1] != (128, 128) or len(times) != len(qm.TILES):
                raise AssertionError(f"tune: lookups {steps}, times {times}")
            del x, w, s, plain, out
    finally:
        set_global_registry(prev)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tuning.clear_memory_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# ckpt: save, kill, resume at 7B width
# ---------------------------------------------------------------------------

# Llama-2-7B's width, 2 layers, f32 params and moments: ~667 M parameters,
# ~8.0 GB of state; 5 steps of b 2, s 1024, saved every 2 steps
CKPT_LEG = dict(layers=2, batch=2, seq=1024, steps=5, save_every=2,
                keep_last_k=2)
CKPT_CHILD = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.CKPT_LEG.update({leg!r})
chip_smoke.ckpt_child({ckpt!r}, {device!r}, {args!r})
"""


def ckpt_args():
    from paddle_tpu_torch.models import LLAMA2_7B

    return LLAMA2_7B._replace(num_layers=CKPT_LEG["layers"])


def _ckpt_batch(step, vocab):
    import numpy as np

    rng = np.random.default_rng(100 + step)   # a per-step-seeded pipeline
    shape = (CKPT_LEG["batch"], CKPT_LEG["seq"])
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def ckpt_run(torch, dev, args, root=None, resume=False):
    """The ckpt leg's engine over LlamaArgs `args` from seed 0 (resumed
    when asked), trained to step CKPT_LEG["steps"]; returns ({step: loss},
    engine)."""
    from paddle_tpu_torch.distributed import HybridParallelEngine

    kw = {}
    if root is not None:
        kw = dict(save_every=CKPT_LEG["save_every"], checkpoint=root,
                  resume=resume, keep_last_k=CKPT_LEG["keep_last_k"])
    eng = HybridParallelEngine(args, dtype=torch.float32, remat=False,
                               lr=1e-4, loss_chunk=128, moments="f32",
                               device=dev, **kw)
    params, opt = eng.init_state(0)
    params, opt, start = eng.maybe_resume(params, opt)
    losses = {}
    for step in range(start, CKPT_LEG["steps"]):
        loss, params, opt = eng.train_batch(
            params, opt, *_ckpt_batch(step, eng.args.vocab_size))
        losses[step] = loss.item()
    if eng.checkpoint_manager is not None:
        eng.checkpoint_manager.wait()
    return losses, eng


def ckpt_child(root, device, args):
    """The ckpt phase's child: the leg (LlamaArgs fields `args`) with
    PADDLE_CHAOS crashing (os._exit) inside step 4's save, after its shards
    are written (the second save's `after_shards` point)."""
    import torch

    from paddle_tpu_torch.models import LlamaArgs

    os.environ["PADDLE_CHAOS"] = "crash_at:after_shards#2"
    losses, _ = ckpt_run(torch, torch.device(device), LlamaArgs(**args),
                         root)
    print(f"UNREACHABLE {losses}", flush=True)


def phase_ckpt(torch, dev):
    """Checkpoints at Llama-2-7B width (2 layers, f32 params and moments,
    B1-B3, B9, B10): (1) 5 steps uninterrupted, saving every 2 steps
    (keep 2), in a temporary directory; (2) a child process runs the same
    leg and is killed (os._exit, PADDLE_CHAOS) inside step 4's save: the
    survivor must see committed_steps() == [2]; (3) resume=True from that
    directory: steps 2-4 must give run (1)'s losses bit for bit. Prints
    the snapshot ms, the write MB/s and the GB on disk; the directory is
    deleted."""
    import shutil
    import tempfile

    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.observability import (MetricsRegistry, hardware,
                                                set_global_registry)

    args = ckpt_args()
    base = tempfile.mkdtemp(prefix="ckpt_")
    reg = MetricsRegistry()
    prev = set_global_registry(reg)
    try:
        torch.cuda.empty_cache()
        root = os.path.join(base, "uninterrupted")
        t0 = time.perf_counter()
        ref, eng = ckpt_run(torch, dev, args, root)
        params = hardware.llama_param_count(eng.args)
        snap = reg.observation("checkpoint/snapshot_seconds")
        save = reg.observation("checkpoint/save_seconds")
        write = reg.observation("checkpoint/write_seconds")
        written = reg.counter("checkpoint/bytes_written")
        on_disk = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, fs in os.walk(root) for f in fs)
        log(f"[ckpt] hidden {args.hidden_size}, {args.num_layers} layers, "
            f"vocab {args.vocab_size}, f32 params and "
            f"moments, b{CKPT_LEG['batch']} s{CKPT_LEG['seq']}: "
            f"{CKPT_LEG['steps']} steps uninterrupted in "
            f"{time.perf_counter() - t0:.1f} s, losses {ref}; "
            f"committed {eng.checkpoint_manager.committed_steps()}; "
            f"snapshot (device to host) {snap['mean'] * 1e3:.1f} ms a save "
            f"(min {snap['min'] * 1e3:.1f}, {snap['count']} saves), save to "
            f"commit {save['mean']:.2f} s, of which the write and commit "
            f"{write['mean']:.2f} s: "
            f"{written / write['count'] / write['mean'] / 1e6:.0f} MB/s "
            f"({written / write['count'] / 1e9:.2f} GB a save); "
            f"{on_disk / 1e9:.2f} GB on disk for "
            f"{len(eng.checkpoint_manager.committed_steps())} snapshots")
        del eng
        shutil.rmtree(root)
        torch.cuda.empty_cache()
        root = os.path.join(base, "killed")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c",
             CKPT_CHILD.format(root=str(ROOT), ckpt=root, device=str(dev),
                               args=args._asdict(), leg=CKPT_LEG)],
            capture_output=True, text=True, timeout=600)
        from paddle_tpu_torch.distributed.checkpoint.chaos import (
            CRASH_EXIT_CODE)

        survivor = CheckpointManager(root=root, registry=MetricsRegistry())
        steps = survivor.committed_steps()
        leftovers = sorted(n for n in os.listdir(root) if ".tmp." in n)
        log(f"[ckpt] the child killed inside step 4's save: exit "
            f"{child.returncode} (the injector's {CRASH_EXIT_CODE}) after "
            f"{time.perf_counter() - t0:.1f} s; the survivor sees committed "
            f"{steps}, staging leftovers {leftovers}")
        if child.returncode != CRASH_EXIT_CODE or steps != [2] or \
                "UNREACHABLE" in child.stdout:
            raise AssertionError(f"ckpt child: rc {child.returncode}, "
                                 f"committed {steps}\n{child.stdout[-2000:]}"
                                 f"\n{child.stderr[-4000:]}")
        t0 = time.perf_counter()
        resumed, eng = ckpt_run(torch, dev, args, root, resume=True)
        rest = reg.observation("checkpoint/restore_seconds")
        same = {s: resumed[s] == ref[s] for s in resumed}
        log(f"[ckpt] resumed from step {min(resumed)} in "
            f"{rest['mean']:.2f} s (restore), steps {sorted(resumed)} in "
            f"{time.perf_counter() - t0:.1f} s: losses {resumed}, "
            f"bit-identical to the uninterrupted run's: {same}; committed "
            f"{eng.checkpoint_manager.committed_steps()}, staging "
            f"leftovers swept: "
            f"{not any('.tmp.' in n for n in os.listdir(root))}; "
            f"{params / 1e6:.1f} M parameters")
        if sorted(resumed) != [2, 3, 4] or not all(same.values()) or \
                eng.checkpoint_manager.committed_steps() != [2, 4]:
            raise AssertionError(f"ckpt resume: {resumed} vs {ref}")
        del eng
    finally:
        set_global_registry(prev)
        shutil.rmtree(base, ignore_errors=True)
        torch.cuda.empty_cache()


def _add(total, launches):
    for k, v in launches.items():
        total[k] += v


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="build,parity,c2,c3,tune,train-check,eager,train,"
                    "train-h2048,ckpt,engine,disagg,router,logits,generate,"
                    "chunked,spec,engine-int8,logits-int8,capacity,timing",
                    help="comma-separated subset of the phases, in order")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if "disagg" in phases and "engine" not in phases:
        ap.error("the disagg phase compares with the engine phase's run")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "paddle_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: the paddle_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False   # the f32 reference
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[card] {name}, {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t_start = time.perf_counter()

    from paddle_tpu_torch.models import (LLAMA2_7B, Llama, init_params,
                                         quantize_params)

    main_err, launches = {}, {k: 0 for k in launch_counts()}
    if "build" in phases:
        phase_build()
    if "parity" in phases:
        main_err = phase_parity(torch, dev)
    if "c2" in phases:
        phase_c2(torch, dev)
    if "c3" in phases:
        phase_c3(torch, dev)
    if "tune" in phases:
        phase_tune(torch, dev)
        torch.cuda.empty_cache()
    if "train-check" in phases:
        phase_train_check(torch, dev)
        torch.cuda.empty_cache()
    if "eager" in phases:
        _add(launches, phase_eager(torch, dev))
        torch.cuda.empty_cache()
    if "train" in phases:
        _add(launches, phase_train(torch, dev, name, "train"))
    if "train-h2048" in phases:
        phase_train(torch, dev, name, "train-h2048")
    torch.cuda.empty_cache()
    if "ckpt" in phases:
        phase_ckpt(torch, dev)
    model = None
    if {"engine", "disagg", "router", "logits", "generate", "chunked",
            "spec", "engine-int8", "logits-int8", "capacity"} & set(phases):
        t0 = time.perf_counter()
        gen_ = torch.Generator(device=dev).manual_seed(0)
        model = Llama(LLAMA2_7B, init_params(LLAMA2_7B, gen_, device=dev,
                                             dtype=torch.bfloat16))
        log(f"[model] Llama-2-7B width, {LLAMA2_7B.num_layers} layers, bf16, "
            f"{sum(t.numel() for t in model.parameters()) / 1e9:.2f} B "
            f"parameters drawn in {time.perf_counter() - t0:.1f} s")
    reqs = eng_stats = None
    if "engine" in phases:
        reqs, eng_launches, eng_stats, eng = phase_engine(torch, dev, model)
        _add(launches, eng_launches)
        phase_profile(torch, dev, eng)
        eng = None
    if "disagg" in phases:
        _add(launches, phase_disagg(torch, dev, model, reqs))
        torch.cuda.empty_cache()
    if "router" in phases:
        _add(launches, phase_router(torch, dev, model))
        torch.cuda.empty_cache()
    if "logits-cuts" in phases:
        phase_logits_cuts(torch, dev, model, reqs[3])
    if "logits" in phases:
        phase_logits(torch, dev, model, reqs[3])
        torch.cuda.empty_cache()
    if "generate" in phases:
        _add(launches, phase_generate(torch, dev, model))
    if "chunked" in phases:
        _add(launches, phase_chunked(torch, dev, model))
        torch.cuda.empty_cache()
    if "spec" in phases:
        _add(launches, phase_spec(torch, dev, model))
        torch.cuda.empty_cache()
    qmodel = qreqs = None
    if {"engine-int8", "logits-int8"} & set(phases):
        t0 = time.perf_counter()
        qmodel = quantize_params(model)
        torch.cuda.synchronize(dev)
        def gib(m):
            return sum(t.numel() * t.element_size()
                       for t in m.parameters()) / 2**30

        log(f"[quantize] quantize_params on the card in "
            f"{time.perf_counter() - t0:.1f} s: {gib(qmodel):.2f} GiB int8 "
            f"model (bf16: {gib(model):.2f} GiB)")
    if "engine-int8" in phases:
        qreqs, q_launches, q_stats, eng = phase_engine(
            torch, dev, qmodel, kv_dtype="int8", label="engine-int8")
        _add(launches, q_launches)
        if eng_stats is not None:
            keys = ("prefix_tokens_hit", "prefix_partial_hits",
                    "radix_splits", "cow_copies")
            diff = {k: (eng_stats["counters"].get(k, 0),
                        q_stats["counters"].get(k, 0)) for k in keys
                    if eng_stats["counters"].get(k, 0)
                    != q_stats["counters"].get(k, 0)}
            share = q_stats["kv_pool_bytes"] / eng_stats["kv_pool_bytes"]
            log(f"[engine-int8] prefix counters equal to the bf16 run's: "
                f"{not diff}; pool bytes {share:.4f}x the bf16 pool's at "
                f"{q_stats['num_pages']} pages (bar 0.51)")
            if diff or share > 0.51 or \
                    q_stats["num_pages"] != eng_stats["num_pages"]:
                raise AssertionError(f"engine-int8 vs engine: counters "
                                     f"{diff}, pool share {share}")
        phase_profile(torch, dev, eng, label="profile-int8")
        eng = None
        _add(launches, phase_generate(torch, dev, qmodel,
                                      label="generate-int8"))
    if "logits-int8" in phases:
        # the bf16 check's token sequence, so the checks differ only in
        # the int8 weights and pool
        phase_logits_int8(torch, dev, qmodel, (reqs or qreqs)[3])
    qmodel = None
    torch.cuda.empty_cache()
    if "capacity" in phases:
        _add(launches, phase_capacity(torch, dev, model))
    main_path = {"eager", "train", "engine", "disagg", "router", "generate",
                 "chunked", "spec", "engine-int8", "capacity"}
    if main_path <= set(phases):
        missing = [k for k, v in launches.items()
                   if v == 0 and k not in OFF_PATH]
        if missing:
            raise AssertionError(f"kernels never launched on the main path: "
                                 f"{missing}")
        stray = {k: launches[k] for k in OFF_PATH if launches[k]}
        if stray:
            raise AssertionError(f"off-path kernels launched on the main "
                                 f"path: {stray}")
    log(f"[main path] launches {launches}")
    model = None
    torch.cuda.empty_cache()
    rows = []
    if "timing" in phases:
        rows = phase_timing(torch, dev, name, main_err, launches)
    log(f"[done] {time.perf_counter() - t_start:.1f} s; peak device memory "
        f"{max(PEAK_SEEN + [torch.cuda.max_memory_allocated(dev)]) / 2**30:.1f}"
        " GiB")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
