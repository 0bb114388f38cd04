"""paddle.quantization of the port (`paddle_tpu/quantization/__init__.py`;
reference `python/paddle/quantization/`, the fake-quant kernels of
`paddle/phi/kernels/fake_quantize_kernel.*` and
`weight_only_linear_kernel.*`).

Fake quantization is a quantize-dequantize round trip in plain PyTorch with
a straight-through gradient (the rounding's noise goes forward, the
identity comes back), so QAT trains through it. Weight-only int8 keeps
int8 codes and a per-output-channel f32 scale (`quantize_absmax`:
dequant = q * scale / 127); its matmul is kernel B8 on a CUDA tensor and
B8's plain version (`dequant_matmul_plain`) on a CPU one, through the
custom operator `kernels.quantized_matmul.weight_only_matmul_op`, which
chooses at call time by the device of its tensors. The JAX package's
`fused=` switch therefore has nothing to switch in the port: it is
accepted and has no effect.
"""

import contextlib as _contextlib

import torch

from paddle_tpu_torch.core.tensor import Tensor, apply

__all__ = [
    "fake_quantize_abs_max", "fake_quantize_dequantize_abs_max",
    "fake_channel_wise_quantize_abs_max",
    "fake_channel_wise_quantize_dequantize_abs_max",
    "fake_quantize_moving_average_abs_max",
    "quantize_linear", "dequantize_linear",
    "weight_quantize", "weight_dequantize", "weight_only_linear",
    "llm_int8_linear",
    "apply_per_channel_scale", "weight_only_int8_patched",
    "QuantConfig", "QAT", "PTQ", "FakeQuanterWithAbsMax",
]


def _ste_round(x):
    """round with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _clip(x, lo, hi):
    """`jnp.clip` as max then min: at a value equal to a bound the gradient
    splits in half between the two arguments, as JAX's does."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def _fake_q_dq(a, scale, bit_length):
    bnd = 2 ** (bit_length - 1) - 1
    s = torch.clamp_min(scale, 1e-9)
    q = _clip(_ste_round(a / s * bnd), -bnd, bnd)
    return q * s / bnd


def _data(x, like=None):
    if isinstance(x, Tensor):
        return x._data
    return torch.as_tensor(x, device=None if like is None else like.device)


def fake_quantize_abs_max(x, bit_length=8, name=None):
    """-> (quantized int8 tensor, scale). Reference fake_quantize_abs_max."""
    bnd = 2 ** (bit_length - 1) - 1
    a = x._data.detach()
    scale = a.abs().max()
    q = torch.clamp(torch.round(a / scale.clamp_min(1e-9) * bnd), -bnd, bnd)
    return Tensor(q.to(torch.int8)), Tensor(scale)


def fake_quantize_dequantize_abs_max(x, bit_length=8, name=None):
    """Quant-dequant round trip with a straight-through gradient (the QAT
    forward)."""
    def fn(a):
        return _fake_q_dq(a, a.detach().abs().max(), bit_length)

    return apply(fn, x, _name="fake_quantize_dequantize_abs_max")


def _channel_scale(a, quant_axis, keepdim):
    red = tuple(i for i in range(a.ndim) if i != quant_axis)
    return a.abs().amax(dim=red, keepdim=keepdim) if red else a.abs()


def fake_channel_wise_quantize_abs_max(x, bit_length=8, quant_axis=0,
                                       name=None):
    bnd = 2 ** (bit_length - 1) - 1
    a = x._data.detach()
    scale = _channel_scale(a, quant_axis, False)
    shape = [1] * a.ndim
    shape[quant_axis] = -1
    q = torch.clamp(torch.round(a / scale.reshape(shape).clamp_min(1e-9)
                                * bnd), -bnd, bnd)
    return Tensor(q.to(torch.int8)), Tensor(scale)


def fake_channel_wise_quantize_dequantize_abs_max(x, bit_length=8,
                                                  quant_axis=0, name=None):
    def fn(a):
        return _fake_q_dq(a, _channel_scale(a.detach(), quant_axis, True),
                          bit_length)

    return apply(fn, x, _name="fake_channel_wise_quantize_dequantize_abs_max")


def fake_quantize_moving_average_abs_max(x, state, bit_length=8, rate=0.9,
                                         name=None):
    """-> (qdq output, new moving-average scale state)."""
    cur = x._data.detach().abs().max()
    st = _data(state, cur).to(cur.device)
    new_state = rate * st + (1 - rate) * cur
    out = apply(lambda a: _fake_q_dq(a, new_state, bit_length), x,
                _name="fake_quantize_moving_average_abs_max")
    return out, Tensor(new_state)


def _axis_scale(s, ndim, quant_axis):
    if quant_axis >= 0 and s.ndim:
        shape = [1] * ndim
        shape[quant_axis] = -1
        s = s.reshape(shape)
    return s


def quantize_linear(x, scale, zero_point=0, bit_length=8, quant_axis=-1,
                    name=None):
    bnd = 2 ** (bit_length - 1) - 1
    a = x._data
    s = _axis_scale(_data(scale, a), a.ndim, quant_axis)
    # ONNX-style linear quant: qmin = -qmax - 1 ([-128, 127] for int8), the
    # reference LinearQuanter convention (quanter/format.py), unlike the
    # symmetric fake-quant family above, which clips to [-bnd, bnd]
    q = torch.clamp(torch.round(a / torch.clamp_min(s, 1e-9)) + zero_point,
                    -bnd - 1, bnd)
    return Tensor(q.to(torch.int8))


def dequantize_linear(x, scale, zero_point=0, quant_axis=-1, name=None):
    a = x._data
    s = _axis_scale(_data(scale, a), a.ndim, quant_axis)
    return Tensor((a.float() - zero_point) * s)


def weight_quantize(x, algo="weight_only_int8", arch=None,
                    group_size=-1, name=None):
    """-> (int8 weight, per-out-channel scale). Reference
    weight_quantize_kernel; weights are [in, out]. group_size=-1
    (per-channel) is the supported granularity; `arch` (a GPU SM selector)
    is accepted and ignored: the codes are the same for every card."""
    if group_size not in (-1, None):
        raise NotImplementedError(
            "group-wise weight quantization (group_size > 0) is not "
            "implemented; use per-channel (group_size=-1)")
    from paddle_tpu_torch.kernels.quantized_matmul import quantize_absmax

    q, scale = quantize_absmax(x._data.detach())
    return Tensor(q), Tensor(scale)


def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float16", arch=None,
                      group_size=-1, name=None):
    if group_size not in (-1, None):
        raise NotImplementedError(
            "group-wise weight dequantization is not implemented")
    from paddle_tpu_torch.framework import dtypes as _dt

    out = x._data.float() * scale._data / 127.0
    return Tensor(out.to(_dt.convert_dtype(out_dtype)))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", arch=None, group_size=-1,
                       name=None):
    """x @ dequant(weight) + bias: kernel B8 on the card (the weight stays
    int8 in device memory, the scale is applied once per output in the
    epilogue, the reference weight_only_linear_kernel's fusion); on the
    CPU, B8's plain version (dequantize into x's dtype, then matmul)."""
    if group_size not in (-1, None):
        raise NotImplementedError(
            "group-wise weight_only_linear is not implemented; use "
            "per-channel scales (group_size=-1)")
    from paddle_tpu_torch.kernels import quantized_matmul as qm

    out = apply(qm.weight_only_matmul_op, x, weight, weight_scale,
                _name="weight_only_linear")
    if bias is not None:
        out = apply(torch.add, out, bias, _name="bias_add")
    return out


def apply_per_channel_scale(x, scales, name=None):
    return apply(lambda a, s: a * s, x, scales,
                 _name="apply_per_channel_scale")


@_contextlib.contextmanager
def weight_only_int8_patched(model, fused=None):
    """Within the context, every quantizable Linear holds an int8 weight, a
    registered per-out-channel scale parameter (state-dict key
    `<weight key>.__scale__`) and a forward through B8's custom operator
    (`kernels.quantized_matmul.weight_only_matmul_op`): the export-time
    counterpart of the reference's weight-only quant passes, in the same
    patch idiom as `ptq_int8.int8_patched`. Yields the quantized weight
    keys; the float weights and forwards are restored on exit.

    fused: accepted for the JAX package's signature and without effect:
    there it pins the Pallas kernel or the jnp composition into a traced
    program; here the operator chooses B8 or its plain version at every
    call by the device of its tensors.
    """
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.kernels import quantized_matmul as qm
    from paddle_tpu_torch.nn.layer.layers import Parameter

    def quantizable(sub):
        w = getattr(sub, "weight", None)
        return (isinstance(sub, nn.Linear) and w is not None
                and w._data.ndim == 2 and min(w._data.shape) >= 16
                and w._data.is_floating_point())

    def make_fwd(layer, scale_param):
        def fwd(x):
            x = x if isinstance(x, Tensor) else Tensor(torch.as_tensor(x))
            y = apply(qm.weight_only_matmul_op, x, layer.weight,
                      scale_param, _name="weight_only_linear")
            if layer.bias is not None:
                y = apply(lambda a, b: a + b.to(a.dtype), y, layer.bias,
                          _name="bias_add")
            return y

        return fwd

    # quantizing a weight mutates the shared Parameter in place, so it is
    # only safe when every module referencing that Parameter is a Linear
    # whose forward this patch rewires: a weight tied into an Embedding
    # (or any raw-matmul consumer) must stay float, or that consumer would
    # silently read raw int8 codes with no scale
    refs = {}
    for _, sub in model.named_sublayers(include_self=True):
        for attr, p in getattr(sub, "_parameters", {}).items():
            if p is not None:
                refs.setdefault(id(p), []).append((sub, attr))

    def only_linear_weight_refs(w):
        return all(isinstance(s, nn.Linear) and attr == "weight"
                   for s, attr in refs.get(id(w), [(None, None)]))

    saved, qkeys, seen = [], [], set()
    shared_scales = {}  # id(weight Parameter) -> its scale Parameter
    try:
        for name, sub in model.named_sublayers(include_self=True):
            if id(sub) in seen:
                continue  # aliased sublayers patch once
            w = getattr(sub, "weight", None)
            if (isinstance(sub, nn.Linear) and w is not None
                    and id(w) in shared_scales):
                # a different Linear tied to an already-quantized Parameter:
                # its weight is int8 now, so it fails the floating check; it
                # must still get the quantized forward (sharing the owner's
                # scale), or it would compute x @ raw_int8 with no scale
                seen.add(id(sub))
                saved.append((sub, "forward" in sub.__dict__,
                              sub.__dict__.get("forward"), None))
                sub.forward = make_fwd(sub, shared_scales[id(w)])
                continue
            if not quantizable(sub) or not only_linear_weight_refs(w):
                continue
            seen.add(id(sub))
            q, scale = qm.quantize_absmax(w._data.detach())
            saved.append((sub, "forward" in sub.__dict__,
                          sub.__dict__.get("forward"), w._data))
            w._data = q
            scale_param = Parameter(scale)
            sub.add_parameter("weight.__scale__", scale_param)
            shared_scales[id(w)] = scale_param
            sub.forward = make_fwd(sub, scale_param)
            qkeys.append(f"{name}.weight" if name else "weight")
        if not qkeys:
            import warnings

            warnings.warn(
                "weight_only_int8: no quantizable Linear weights found "
                "(only nn.Linear sublayers with 2-D float weights >= "
                "16 on both dims, not tied into non-Linear consumers, "
                "are quantized) — the export keeps full-width floats")
        yield qkeys
    finally:
        for sub, had_attr, fwd, wd in saved:
            if had_attr:
                sub.forward = fwd
            else:
                sub.__dict__.pop("forward", None)
            if wd is not None:  # None = tied alias; the owner restores
                sub.weight._data = wd
            sub._parameters.pop("weight.__scale__", None)


# -- QAT / PTQ high-level API (reference quantization/config.py, qat.py) ----


class FakeQuanterWithAbsMax:
    """Per-layer activation/weight fake quanter (QAT observer)."""

    def __init__(self, bit_length=8, moving_rate=0.9):
        self.bit_length = bit_length
        self.moving_rate = moving_rate
        self.scale = torch.zeros(())

    def __call__(self, x):
        out, new_scale = fake_quantize_moving_average_abs_max(
            x, Tensor(self.scale), self.bit_length, self.moving_rate)
        self.scale = new_scale._data
        return out


class QuantConfig:
    """Reference `quantization/config.py` QuantConfig: which layer types get
    quantized and with what quanter. The activation/weight quanters act as
    prototypes: each quantized layer gets a fresh quanter with the same
    hyperparameters."""

    def __init__(self, activation=None, weight=None):
        self.activation = activation or FakeQuanterWithAbsMax()
        self.weight = weight or FakeQuanterWithAbsMax()
        self._types = []

    def add_type_config(self, layer_types, activation=None, weight=None):
        if not isinstance(layer_types, (list, tuple)):
            layer_types = [layer_types]
        self._types.extend(layer_types)
        if activation is not None:
            self.activation = activation
        if weight is not None:
            self.weight = weight

    def make_activation_quanter(self):
        proto = self.activation
        return FakeQuanterWithAbsMax(proto.bit_length, proto.moving_rate)

    def weight_bit_length(self):
        return self.weight.bit_length

    def quanted_types(self):
        if self._types:
            return tuple(self._types)
        from paddle_tpu_torch import nn

        return (nn.Linear, nn.Conv2D)


class QAT:
    """Quantization-aware training driver (reference quantization/qat.py)."""

    def __init__(self, config=None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=True):
        # wrap matching leaf layers' forward with weight+activation quanters
        types = self.config.quanted_types()
        w_bits = self.config.weight_bit_length()
        for _, sub in model.named_sublayers():
            if isinstance(sub, types) and not hasattr(sub, "_qat_wrapped"):
                sub._qat_wrapped = True
                orig = sub.forward
                quanter = self.config.make_activation_quanter()

                def make_fwd(layer, orig_fwd, q):
                    def fwd(*args, **kwargs):
                        w = layer.weight
                        saved = w._data
                        w._data = fake_quantize_dequantize_abs_max(
                            Tensor(saved), bit_length=w_bits)._data
                        try:
                            return q(orig_fwd(*args, **kwargs))
                        finally:
                            w._data = saved

                    return fwd

                sub.forward = make_fwd(sub, orig, quanter)
        return model


class PTQ:
    """Post-training quantization: observe abs-max, then fold int8 weights
    (reference quantization/ptq.py)."""

    def __init__(self, config=None):
        self.config = config or QuantConfig()

    def quantize(self, model, inplace=True):
        types = self.config.quanted_types()
        for _, sub in model.named_sublayers():
            if isinstance(sub, types) and hasattr(sub, "weight"):
                q, scale = weight_quantize(sub.weight)
                sub._quant_weight = q
                sub._quant_scale = scale
        return model

    def convert(self, model, inplace=True):
        """Replace observed weights by their int8 round trip."""
        from paddle_tpu_torch.nn.layer.layers import _set_data

        for _, sub in model.named_sublayers():
            if hasattr(sub, "_quant_weight"):
                w = sub.weight
                _set_data(w, weight_dequantize(
                    sub._quant_weight, sub._quant_scale)._data.to(
                        w._data.dtype))
        return model


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold=6.0, name=None):
    """LLM.int8() mixed-precision matmul (reference
    `python/paddle/nn/quant/quantized_linear.py` llm_int8_linear /
    `phi/kernels/llm_int8_linear_kernel`): activations are quantized to
    int8 per row for the int8 x int8 product, except the feature columns
    whose max-abs exceeds `threshold` (emergent outliers), which keep the
    float path. Without the split the outlier columns would dominate the
    per-row activation scale and crush everyone else's quant resolution."""
    def fn(a, w, s):
        wscale = s.float() / 127.0
        wf = w.float() * wscale
        a32 = a.float()
        amax_col = a32.abs().amax(dim=tuple(range(a.ndim - 1)), keepdim=True)
        outlier = (amax_col > threshold).float()
        a_in = a32 * (1 - outlier)
        # per-row symmetric int8 activation quant on the non-outlier part
        ascale = torch.clamp_min(a_in.abs().amax(dim=-1, keepdim=True)
                                 / 127.0, 1e-9)
        aq = torch.round(a_in / ascale)  # int8-valued
        quant = (aq @ w.float()) * ascale * wscale
        dense = (a32 * outlier) @ wf   # outlier columns stay float
        return (dense + quant).to(a.dtype)

    out = apply(fn, x, weight, weight_scale, _name="llm_int8_linear")
    if bias is not None:
        out = apply(torch.add, out, bias, _name="bias_add")
    return out
