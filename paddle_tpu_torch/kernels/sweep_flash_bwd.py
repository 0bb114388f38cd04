"""Where kernels B2 and B3 (the flash-attention backward's TMA + wgmma
kernels) spend their time, on one NVIDIA card.

    python3 -m paddle_tpu_torch.kernels.sweep_flash_bwd

At the training legs' micro-batches (b2 h32 s2048 and b4 h16 s1024, d128,
causal, bf16), B2 and B3 through their C entry points beside SDPA's
backward, then copies of the two kernels with a part taken out, built
from edited copies of `csrc/flash_attention.cu` into
`build/paddle_tpu_torch/sweep_flash_bwd/`:

  - without the streamed copies (B2's K and V tiles, B3's Q and dO tiles:
    the barriers are still passed, the tiles never land);
  - without the exp and dS work between the products;
  - without both;
  - the copies and barriers alone (no products, no exp).

The edited copies' outputs are wrong by construction; only their times
are read. Times are CUDA-event medians of 20 calls, the L2
cache flushed before each. Needs a card and nvcc; prints the card's name and
power limit first.
"""

from __future__ import annotations

import ctypes
import math
import subprocess

import torch

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels.sweep_b8 import _ms

SHAPES = ((2, 2048, 32, 128), (4, 1024, 16, 128))

# (text, replacement) edits of csrc/flash_attention.cu, each found once;
# B2's ring wait tells its producer from B1's
B2_WAIT = ("        if (it >= kDqStages) "
           "mbar_wait(&empty[s], (it / kDqStages - 1) & 1);")
STREAMS = [
    # B2: the K and V tiles
    (B2_WAIT + """
        mbar_expect_tx(&kfull[s], kKVBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(Ks + s * kKVBytes + a * kKVAtom, &tmap_k, &kfull[s],
                      a * 64, hk, j0, b);
        mbar_expect_tx(&vfull[s], kKVBytes);
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load_4d(Vs + s * kKVBytes + a * kKVAtom, &tmap_v, &vfull[s],
                      a * 64, hk, j0, b);""",
     B2_WAIT + """
        mbar_arrive(&kfull[s]);
        mbar_arrive(&vfull[s]);"""),
    # B3: the Q and dO tiles
    ("""      mbar_expect_tx(&full[s], 2 * kQBytes);
#pragma unroll
      for (int a = 0; a < kAtoms; ++a) {
        tma_load_4d(Qs + s * kQBytes + a * kQAtom, &tmap_q, &full[s],
                    a * 64, h, r0, b);
        tma_load_4d(dOs + s * kQBytes + a * kQAtom, &tmap_do, &full[s],
                    a * 64, h, r0, b);
      }""",
     "      mbar_arrive(&full[s]);")]
ELEMENTWISE = [
    ("sc[i] = exp2f(fmaf(sc[i], sl2, ((i / 2) % 2) ? -lB : -lA));",
     "sc[i] *= sl2;"),
    ("sc[i] *= dp[i] - (((i / 2) % 2) ? dB : dA);", "sc[i] += dp[i];"),
    ("sc[i] = exp2f(fmaf(sc[i], sl2, -l.x));", "sc[i] *= l.x;"),
    ("sc[i + 1] = exp2f(fmaf(sc[i + 1], sl2, -l.y));",
     "sc[i + 1] *= l.y;"),
    ("dp[i] = sc[i] * (dp[i] - d.x);", "dp[i] += d.x;"),
    ("dp[i + 1] = sc[i + 1] * (dp[i + 1] - d.y);", "dp[i + 1] += d.y;")]
PRODUCTS = [
    ("mma_ss_kk<D>(sc, q_addr, kQAtom, k_addr, kKVAtom);", ""),
    ("mma_ss_kk<D>(dp, do_addr, kQAtom, v_addr, kKVAtom);", ""),
    ("mma_rs_mn<D>(acc, ds, k_addr, kKVAtom);", ""),
    ("mma_ss_kk<D>(sc, k_addr, kKAtom, q_addr, kQAtom);", ""),
    ("mma_ss_kk<D>(dp, v_addr, kKAtom, do_addr, kQAtom);", ""),
    ("mma_rs_mn<D>(dva, pa, do_addr, kQAtom);", ""),
    ("mma_rs_mn<D>(dka, da, q_addr, kQAtom);", "")]
VARIANTS = {"without the streamed copies": STREAMS,
            "without the exp and dS work": ELEMENTWISE,
            "without both": STREAMS + ELEMENTWISE,
            "the copies and barriers alone": ELEMENTWISE + PRODUCTS}


def _load(so):
    lib = ctypes.CDLL(str(so))
    for fn, argtypes in _build._SIGNATURES["flash_attention"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _variant_libs():
    """{name: loaded library} of the edited copies, one nvcc each, in
    parallel."""
    src = _build.SOURCES["flash_attention"]
    out_dir = _build.BUILD_DIR / "sweep_flash_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"text not found once: {old[:60]}")
            text = text.replace(old, new)
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
        libs[name] = _load(so)
    return libs


def _callers(lib, q, k, v, do, lse, delta, dq, dk, dv):
    """(B2, B3) calls of `lib`'s entry points on these tensors."""
    b, s, h, d = q.shape
    dims = (b, s, s, h, h, d, 1, 1, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
              lse.data_ptr(), delta.data_ptr())

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    return (lambda: check(lib.pt_flash_bwd_dq(*common, dq.data_ptr(),
                                              *dims)),
            lambda: check(lib.pt_flash_bwd_dkv(*common, dk.data_ptr(),
                                               dv.data_ptr(), *dims)))


def main():
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    libs = {"the kernels": _build.lib("flash_attention"),
            **_variant_libs()}
    for b, s, h, d in SHAPES:
        g = torch.Generator(device=dev).manual_seed(5)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev)
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = fa.flash_fwd(q, k, v, True)
        delta = fa._delta(out, do)
        dq = torch.empty_like(q)
        dk = torch.empty(k.shape, dtype=torch.float32, device=dev)
        dv = torch.empty_like(dk)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        lq, lk, lv = (x.clone().requires_grad_() for x in (qt, kt, vt))
        lout = torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, is_causal=True)
        sdpa = _ms(lambda: torch.autograd.grad(lout, (lq, lk, lv), dot,
                                               retain_graph=True), flush)
        print(f"b{b} h{h} s{s} d{d} causal bf16: SDPA's backward "
              f"{sdpa:.4f} ms", flush=True)
        for name, lib in libs.items():
            b2, b3 = _callers(lib, q, k, v, do, lse, delta, dq, dk, dv)
            print(f"  {name}: B2 {_ms(b2, flush):.4f} ms, B3 "
                  f"{_ms(b3, flush):.4f} ms", flush=True)


if __name__ == "__main__":
    main()
