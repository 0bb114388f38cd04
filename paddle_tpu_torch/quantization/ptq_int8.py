"""Activation-int8 post-training quantization for the export path
(`paddle_tpu/quantization/ptq_int8.py`; reference
`python/paddle/nn/quant/format.py:65,88`, LinearQuanter and
LinearQuanterDequanter, run by the analysis predictor's int8 passes).

Calibration records each quantizable layer's input absmax with eager
forward pre-hooks; `jit.save(quantize='int8_ptq', calib_reader=...)` then
patches each calibrated Linear and Conv2D so the exported program carries
int8 weights and int8 activation math, with the dequantization folded into
one output scale (s_x * s_w per channel).

The JAX package accumulates int8 x int8 in int32
(`preferred_element_type=jnp.int32`). The port gives the same integers by
an exact route on every device. A product of codes in f32 is exact only
while K * 127^2 < 2^24 (K < 1040); 7B-width Linears (K 4096, 11008) and
3x3x512 convolutions are past that. So:
  - Linear: the custom operator `paddle_tpu_torch::int8_matmul` chooses at
    call time, by device: int32 accumulation on the CPU (`torch.matmul`
    of int32 codes), `torch._int_mm` (int8 tensor cores, int32 out) on the
    card where its shape rules hold (more than 16 rows, K and N multiples
    of 8), else an f64 product of the codes, exact for any K under 2^39;
  - Conv2D: an f64 convolution of the codes on every device, exact for the
    same reason (every partial sum is an integer below 2^53), cast to int32.
"""

import contextlib

import numpy as np
import torch

from paddle_tpu_torch.core.tensor import Tensor

__all__ = ["calibrate_absmax", "int8_patched"]


def _quantizable(sub):
    from paddle_tpu_torch import nn

    if not isinstance(sub, (nn.Linear, nn.Conv2D)):
        return False
    w = getattr(sub, "weight", None)
    return w is not None and w._data.ndim in (2, 4) and \
        w._data.is_floating_point()


def calibrate_absmax(model, calib_reader, max_batches=32):
    """Min-max observer calibration: run eager forwards over calib batches,
    recording each quantizable layer's input absmax. Returns
    {sublayer_name: absmax}. (Reference PTQ observer pass,
    `python/paddle/quantization/ptq.py` + AbsmaxObserver.)"""
    from paddle_tpu_torch.core.tensor import to_tensor

    stats = {}
    handles = []
    seen = set()
    for name, sub in model.named_sublayers(include_self=True):
        if not _quantizable(sub) or id(sub) in seen:
            continue  # a sublayer aliased under two parents observes once
        seen.add(id(sub))

        def mk(nm):
            def hook(layer, inputs):
                x = inputs[0]
                xd = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
                m = float(xd.detach().float().abs().max())
                stats[nm] = max(stats.get(nm, 0.0), m)

            return hook

        handles.append(sub.register_forward_pre_hook(mk(name)))
    was_training = getattr(model, "training", False)
    model.eval()
    try:
        n = 0
        for batch in calib_reader:
            if n >= max_batches:
                break
            if not isinstance(batch, (list, tuple)):
                batch = (batch,)
            model(*[b if isinstance(b, Tensor) else to_tensor(np.asarray(b))
                    for b in batch])
            n += 1
        if n == 0:
            raise ValueError("int8_ptq calibration: calib_reader yielded "
                             "no batches")
    finally:
        for h in handles:
            h.remove()
        if was_training:
            model.train()
    return stats


@torch.library.custom_op("paddle_tpu_torch::int8_matmul", mutates_args=())
def _int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] int8 @ w [K, N] int8 -> [..., N] int32, exactly."""
    k, n = w.shape
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if x.device.type == "cpu":
        acc = x2.to(torch.int32) @ w.to(torch.int32)
    elif m > 16 and k % 8 == 0 and n % 8 == 0:
        acc = torch._int_mm(x2.contiguous(), w.contiguous())
    else:
        acc = torch.round(x2.double() @ w.double()).to(torch.int32)
    return acc.reshape(*x.shape[:-1], n)


@_int8_matmul.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:-1], w.shape[1]), dtype=torch.int32)


def _q_linear_forward(layer, s_x, s_xw):
    """s_x: the input scale (a float32 value); s_xw: s_x * s_w [N] f32."""
    def fwd(x):
        xd = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
        od = xd.dtype
        xq = torch.clamp(torch.round(xd.float() / s_x), -127, 127).to(
            torch.int8)
        acc = _int8_matmul(xq, layer.weight._data)
        y = acc.float() * s_xw
        if layer.bias is not None:
            y = y + layer.bias._data.float()
        return Tensor(y.to(od))

    return fwd


def _conv_padding(pad):
    if isinstance(pad, str):
        return pad.lower()
    if isinstance(pad, int):
        return pad
    return tuple(int(p) for p in pad)


def _q_conv2d_forward(layer, s_x, s_xw):
    def fwd(x):
        xd = x._data if isinstance(x, Tensor) else torch.as_tensor(x)
        od = xd.dtype
        xq = torch.clamp(torch.round(xd.float() / s_x), -127, 127)
        acc = torch.nn.functional.conv2d(
            xq.double(), layer.weight._data.double(),
            stride=tuple(layer._stride), padding=_conv_padding(layer._padding),
            dilation=tuple(layer._dilation), groups=layer._groups)
        acc = torch.round(acc).to(torch.int32)
        y = acc.float() * s_xw[None, :, None, None]
        if layer.bias is not None:
            y = y + layer.bias._data.float()[None, :, None, None]
        return Tensor(y.to(od))

    return fwd


@contextlib.contextmanager
def int8_patched(model, stats):
    """Within the context, every calibrated quantizable sublayer holds an
    int8 weight and a forward doing int8 activation math; on exit the
    float weights and original forwards are restored. Yields the list of
    quantized weight param names (state_dict keys)."""
    from paddle_tpu_torch import nn

    saved = []
    qkeys = []
    seen = set()
    try:
        for name, sub in model.named_sublayers(include_self=True):
            if not _quantizable(sub) or name not in stats \
                    or id(sub) in seen:
                # aliased sublayers patch once: a second pass would
                # re-quantize the already-int8 weight into garbage
                continue
            seen.add(id(sub))
            w = sub.weight
            wd = w._data.detach().float().cpu().numpy()
            if isinstance(sub, nn.Linear):  # weight [in, out]
                s_w = np.maximum(np.abs(wd).max(axis=0), 1e-9) / 127.0
                q = np.clip(np.round(wd / s_w), -127, 127)
            else:  # conv weight [out, in/g, kh, kw]
                s_w = np.maximum(
                    np.abs(wd).reshape(wd.shape[0], -1).max(axis=1),
                    1e-9) / 127.0
                q = np.clip(np.round(wd / s_w[:, None, None, None]),
                            -127, 127)
            s_x = np.float32(max(stats[name], 1e-9) / 127.0)
            # one f32 output scale a channel, s_x * s_w rounded once, as
            # the JAX forward computes it
            s_xw = torch.from_numpy(s_x * s_w.astype(np.float32)).to(
                w._data.device)
            saved.append((sub, "forward" in sub.__dict__,
                          sub.__dict__.get("forward"), w._data))
            w._data = torch.from_numpy(q.astype(np.int8)).to(w._data.device)
            mk = (_q_linear_forward if isinstance(sub, nn.Linear)
                  else _q_conv2d_forward)
            sub.forward = mk(sub, float(s_x), s_xw)
            qkeys.append(f"{name}.weight" if name else "weight")
        yield qkeys
    finally:
        for sub, had_attr, fwd, wd in saved:
            if had_attr:
                sub.forward = fwd
            else:
                sub.__dict__.pop("forward", None)
            sub.weight._data = wd
