"""Device times of the decode kernels B4-B8 through their wrappers, at the
kernel table's shapes (PERF.md §6) and at GPT-2's decode in the router (12
kv heads of 64, one to four rows): the times that fault C2's row-local
split cut moves, on one NVIDIA card.

    python3 -m paddle_tpu_torch.kernels.sweep_c2

It uses only the wrappers' public signatures and `kernels/timing.py`, so
it also times another checkout of the package: run it from that checkout
with the package on the path, e.g. the parent commit unpacked under
`build/` (`git archive`):

    cd build/parent && PYTHONPATH=. python3 ../../paddle_tpu_torch/kernels/sweep_c2.py

Times are CUDA-event medians of 20 calls under `timing.METHOD` (the L2
flushed before each call, the card held while the host enqueues it).
Prints the card's name and power limit, one line a shape, and one JSON
line {label: ms} last.
"""

from __future__ import annotations

import json
import subprocess

import torch

from paddle_tpu_torch.kernels import attention as at
from paddle_tpu_torch.kernels import quantized_matmul as qm
from paddle_tpu_torch.kernels import timing

# the kernel table's ragged rows (b=8, 32 kv heads, tables of 128 pages of
# 16, a 2048-key cache) and the engine's decode rows (256-319 keys)
TABLE_POS = (2047, 1500, 777, 513, 64, 17, 1, 0)
ENGINE_POS = tuple(256 + 9 * i for i in range(8))
# GPT-2 in the router: prompts of 144-192 tokens, 32 new ones
GPT2_POS = (200, 176, 150, 190)


def _paged(dev, b, nh, nkv, hd, ps, P, pos, q8, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = 1 + b * P
    shape = (n_pages, nkv, ps, hd)
    bt = (torch.randperm(n_pages - 1, device=dev, generator=g) + 1) \
        .reshape(b, P).to(torch.int32).contiguous()
    q = torch.randn(b, 1, nh, hd, device=dev, generator=g).bfloat16()
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    if not q8:
        pk = torch.randn(shape, device=dev, generator=g).bfloat16()
        pv = torch.randn(shape, device=dev, generator=g).bfloat16()
        return lambda **kw: at.paged_decode_attention(q, pk, pv, bt, p, **kw)
    kq, vq = (torch.randint(-127, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(n_pages, nkv, generator=g, device=dev) * 2 + 0.5
              for _ in range(2))
    return lambda **kw: at.paged_decode_attention(q, kq, vq, bt, p,
                                                  k_scale=ks, v_scale=vs,
                                                  **kw)


def _cache(dev, b, s, nh, nkv, hd, length, pos, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    ck = torch.randn(b, nkv, length, hd, device=dev, generator=g).bfloat16()
    cv = torch.randn(b, nkv, length, hd, device=dev, generator=g).bfloat16()
    q = torch.randn(b, s, nh, hd, device=dev, generator=g).bfloat16()
    return q, ck, cv, torch.tensor(pos, dtype=torch.int32, device=dev)


def cases(dev):
    """{label: a call} at the shapes this sweep times."""
    out = {}
    for q8, kid in ((False, "B6"), (True, "B7")):
        call = _paged(dev, 8, 32, 32, 128, 16, 128, TABLE_POS, q8)
        out[f"{kid} b=8 ragged to 2047"] = call
        call = _paged(dev, 8, 32, 32, 128, 16, 128, ENGINE_POS, q8)
        out[f"{kid} b=8 engine's 257-320 keys, max_pos"] = (
            lambda call=call: call(max_pos=max(ENGINE_POS)))
    q, ck, cv, p = _cache(dev, 8, 1, 32, 32, 128, 2048, TABLE_POS)
    out["B4 b=8 ragged to 2047"] = lambda: at.decode_attention(q, ck, cv, p)
    q5, ck5, cv5, p5 = _cache(dev, 1, 16, 32, 32, 128, 2064, (512,))
    out["B5 b=1 s=16 after 512"] = lambda: at.window_attention(q5, ck5, cv5,
                                                                p5)
    for b in (1, 2, 4):
        pos = GPT2_POS[:b]
        qg, ckg, cvg, pg = _cache(dev, b, 1, 12, 12, 64, 1024, pos)
        out[f"B4 GPT-2 b={b}"] = (lambda qg=qg, ckg=ckg, cvg=cvg, pg=pg:
                                  at.decode_attention(qg, ckg, cvg, pg))
        qw, ckw, cvw, pw = _cache(dev, b, 16, 12, 12, 64, 1024, pos)
        out[f"B5 GPT-2 b={b} s=16"] = (lambda qw=qw, ckw=ckw, cvw=cvw, pw=pw:
                                       at.window_attention(qw, ckw, cvw, pw))
    for m in (1, 8, 16):
        for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
            g = torch.Generator(device=dev).manual_seed(4)
            x = torch.randn(m, k, generator=g, device=dev).bfloat16()
            w, s = qm.quantize_absmax(torch.randn(k, n, generator=g,
                                                  device=dev) * 0.02)
            out[f"B8 GEMV M={m} K={k} N={n}"] = (
                lambda x=x, w=w, s=s: qm.weight_only_matmul(x, w, s))
    return out


def main():
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0],
          flush=True)
    l2 = timing.ColdL2(dev)
    times = {}
    for label, call in cases(dev).items():
        times[label] = timing.cold_ms(call, l2)
        print(f"{label}: {times[label]:.4f} ms", flush=True)
    print(json.dumps(times))


if __name__ == "__main__":
    main()
