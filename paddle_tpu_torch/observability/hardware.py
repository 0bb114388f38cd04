"""The card's peak rates and the model-FLOPs formulas that MFU and the
kernel bounds read (the port's counterpart of
`paddle_tpu/observability/hardware.py`, with NVIDIA cards in place of
TPUs).

`PEAKS` is the one table of peak rates in the port: the training
monitor's MFU and `chip_smoke.py`'s kernel bounds both read it. Keyed by a
substring of `torch.cuda.get_device_name`, first match wins (so the PCIe
card's row comes before the plain "H100" of the SXM card, whose name is
"NVIDIA H100 80GB HBM3").
"""

from __future__ import annotations

import torch

__all__ = ["PEAKS", "peaks_for", "detect_device_name", "detect_peak_flops",
           "llama_param_count", "llama_flops_per_token"]

# published peaks (NVIDIA data sheets, dense): (memory bytes/s, bf16 flop/s)
PEAKS = {"H100 PCIe": (2.0e12, 756e12), "H100": (3.35e12, 989e12)}


def peaks_for(name):
    """(bytes/s, bf16 flop/s) of the card called `name`, or None when the
    table has no row for it."""
    for key, val in PEAKS.items():
        if key in str(name):
            return val
    return None


def detect_device_name(device=None):
    """`torch.cuda.get_device_name` of `device` (a CUDA device; the
    current one when None), or "cpu" for a CPU device or when there is no
    card."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(device)


def detect_peak_flops(device=None):
    """Peak bf16 FLOP/s of the card, or None when unknown (the CPU)."""
    rates = peaks_for(detect_device_name(device))
    return rates[1] if rates else None


def llama_param_count(args):
    """Parameter count from a LlamaArgs-shaped object (hidden_size,
    intermediate_size, vocab_size, num_layers, num_heads, num_kv_heads)."""
    h, i, v, L = (args.hidden_size, args.intermediate_size, args.vocab_size,
                  args.num_layers)
    hd = h // args.num_heads
    per_layer = (h * args.num_heads * hd + 2 * h * args.num_kv_heads * hd
                 + args.num_heads * hd * h + 3 * h * i + 2 * h)
    return v * h * 2 + L * per_layer + h


def llama_flops_per_token(args, seq):
    """Training FLOPs a token: 6·N for the matmuls plus causal attention,
    12·L·h·s/2 (model FLOPs: a remat recompute is not counted)."""
    return 6 * llama_param_count(args) + 6 * args.num_layers \
        * args.hidden_size * seq
