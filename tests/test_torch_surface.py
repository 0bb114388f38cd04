"""The port's eager surface against the JAX package's, by name: every public
callable of the six op modules is exported by the port's module of the
same name, every Tensor method the JAX package installs is a method of the
port's Tensor, and what is left for the second part of ROADMAP A10a is one
explicit list here (and in ROADMAP), so nothing is missing silently."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import importlib

import pytest

import paddle_tpu
import paddle_tpu_torch
import torch_op_cases as T
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu_torch.core.tensor import Tensor

MODULES = ("creation", "math", "manipulation", "logic", "search", "linalg")

# ROADMAP A10a part 2, in its order: ops/extras.py, ops/legacy_ps.py,
# _C_ops.py, the linalg.py and fft.py namespaces, framework/io.py,
# core/native.py. The Tensor methods that wait for them:
PART2_TENSOR_METHODS = {
    # ops/extras.py
    "as_strided", "bitwise_invert", "bitwise_invert_", "block_diag",
    "cdist", "combinations", "cumulative_trapezoid", "diagonal_scatter",
    "dsplit", "frexp", "histogram_bin_edges", "hsplit", "index_fill",
    "index_fill_", "is_complex", "is_floating_point", "is_integer", "isin",
    "isneginf", "isposinf", "less", "less_", "matrix_transpose",
    "multigammaln", "multigammaln_", "nanquantile", "polar", "reverse",
    "sgn", "signbit", "sinc", "sinc_", "slice_scatter", "take",
    "tensor_split", "trapezoid", "unflatten", "unfold", "vander", "view_as",
    "vsplit",
    # paddle_tpu.signal (A10g) and static.create_parameter (A10f)
    "stft", "istft", "create_parameter",
}
PART2_MODULES = ("paddle_tpu.ops.extras", "paddle_tpu.ops.legacy_ps",
                 "paddle_tpu.framework.io")


def _public(module):
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", None) == module.__name__)


@pytest.mark.parametrize("name", MODULES)
def test_every_public_callable_is_exported_by_the_port(name):
    ref = importlib.import_module(f"paddle_tpu.ops.{name}")
    port = importlib.import_module(f"paddle_tpu_torch.ops.{name}")
    names = _public(ref)
    assert names == _public(port)
    assert sorted(port.__all__) == names
    assert {c.name for c in T.cases(name)} == set(names)


def test_the_six_modules_hold_315_ops():
    assert sum(len(_public(importlib.import_module(
        f"paddle_tpu_torch.ops.{m}"))) for m in MODULES) == 315
    assert len(T.CASES) == 315


def _methods(cls):
    return {n for n in dir(cls) if not n.startswith("__")
            and callable(getattr(cls, n))
            and not isinstance(getattr(cls, n), property)}


def test_every_tensor_method_is_ported_or_listed_for_part_2():
    ref = _methods(RefTensor) - {"_refill"}
    missing = ref - _methods(Tensor)
    assert missing == PART2_TENSOR_METHODS


def test_the_top_level_namespace_carries_the_six_modules():
    """`import paddle_tpu_torch as paddle` gives every op the JAX package's
    top level gives from the six modules (and their in-place variants);
    the rest waits for part 2."""
    ref_names = {n for n in dir(paddle_tpu) if not n.startswith("_")
                 and callable(getattr(paddle_tpu, n))}
    missing = {n for n in ref_names if not hasattr(paddle_tpu_torch, n)}
    part2 = {n for n in missing if getattr(getattr(paddle_tpu, n),
                                           "__module__", "") in PART2_MODULES
             or n.rstrip("_") in PART2_TENSOR_METHODS}
    # not ops: hapi's Model and nn's ParamAttr (A10b), the dispatch waist
    # and the dtype leftovers the JAX package's star imports carry along
    rest = missing - part2
    assert rest == {"Model", "ParamAttr", "apply",
                    "apply_multi", "builtins_slice", "float8_e4m3fn",
                    "float8_e5m2"}
    for n in ("to_tensor", "Tensor", "grad", "no_grad", "seed",
              "set_device", "matmul", "flash_attention"):
        assert hasattr(paddle_tpu_torch, n) or \
            hasattr(paddle_tpu_torch.nn.functional, n)


def test_flags_keep_the_jax_packages_defaults_and_say_they_do_nothing():
    from paddle_tpu_torch.framework import flags

    names = sorted(flags._DEFAULTS)
    assert paddle_tpu_torch.get_flags(names) == paddle_tpu.get_flags(names)
    saved = paddle_tpu_torch.get_flags(names)
    try:
        with pytest.warns(UserWarning, match="no effect"):
            paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf": True})
        paddle_tpu_torch.set_flags({"FLAGS_v": 3})  # recorded, no warning
        assert paddle_tpu_torch.get_flags(
            ["FLAGS_check_nan_inf", "FLAGS_v"]) == {
                "FLAGS_check_nan_inf": True, "FLAGS_v": 3}
    finally:
        flags._flags.update(saved)
    assert flags._from_env("FLAGS_benchmark", "true") is True
    assert flags._from_env("FLAGS_v", "2") == 2
    assert flags._from_env("FLAGS_fraction_of_gpu_memory_to_use",
                           "0.5") == 0.5
