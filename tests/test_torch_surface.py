"""The port's eager surface against the JAX package's, by name: every public
callable of the op modules, of `linalg`, `fft`, `framework/io` and of
`nn.functional` is exported by the port's module of the same name and has a
case in the op table; `_C_ops` has the JAX module's names with equal
signatures; every Tensor method the JAX package installs is a method of the
port's Tensor. What waits for a later slice is explicit here (and in
ROADMAP): the Tensor methods not ported yet (`PART2_TENSOR_METHODS`) and
the `_C_ops` targets in unported namespaces (`C_OPS_LATER`). The static
mode's toggles (`STATIC_TOGGLES`) are not ops and have no case in the op
table."""

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import importlib
import inspect

import pytest

import paddle_tpu
import paddle_tpu_torch
import torch_op_cases as T
from paddle_tpu.core.tensor import Tensor as RefTensor
from paddle_tpu_torch.core.tensor import Tensor
import torch

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

MODULES = ("creation", "math", "manipulation", "logic", "search", "linalg")

# the static graph's mode toggles of extras (ported with A10f part 2): not
# ops, so the op table has no case for them
STATIC_TOGGLES = ("disable_static", "enable_static")
# the Tensor methods still to port: paddle_tpu.signal (A10g)
PART2_TENSOR_METHODS = {"stft", "istft"}
# `_C_ops` targets in namespaces a later slice ports (they raise when
# called): geometric, signal and text (A10g); the 10 quantization targets
# resolve since A10f part 1
C_OPS_LATER = {"paddle.geometric.": ("A10g", 7),
               "paddle.signal.": ("A10g", 3), "paddle.text.": ("A10g", 1)}
# module of the JAX package -> the port's module of the same surface, and
# the op table's name for it
PART2 = {"paddle_tpu.ops.extras": "extras",
         "paddle_tpu.ops.legacy_ps": "legacy_ps",
         "paddle_tpu.fft": "fft",
         "paddle_tpu.nn.functional.activation": "functional.activation",
         "paddle_tpu.nn.functional.common": "functional.common",
         "paddle_tpu.nn.functional.norm": "functional.norm",
         "paddle_tpu.nn.functional.loss": "functional.loss",
         "paddle_tpu.nn.functional.conv": "functional.conv",
         "paddle_tpu.nn.functional.pooling": "functional.pooling",
         "paddle_tpu.nn.functional.extra_fns": "functional.extra_fns"}


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
    assert len(T.cases(*MODULES)) == 315


@pytest.mark.parametrize("ref_name", sorted(PART2))
def test_every_part_2_callable_is_exported_and_has_a_case(ref_name):
    """extras, legacy_ps, fft and the seven nn.functional files: the same
    public callables, each with a case in the op table (but the static
    mode's toggles, which are not ops)."""
    ref = importlib.import_module(ref_name)
    port = importlib.import_module(ref_name.replace("paddle_tpu",
                                                    "paddle_tpu_torch", 1))
    names = _public(ref)
    assert names == _public(port)
    if hasattr(ref, "__all__"):
        assert sorted(port.__all__) == sorted(ref.__all__)
    else:
        assert set(port.__all__) == set(names)
    exported = {n for n in set(port.__all__) | set(names)
                if callable(getattr(port, n))}
    assert {c.name for c in T.cases(PART2[ref_name])} == \
        exported - set(STATIC_TOGGLES)


def test_the_namespaces_and_io_match_the_jax_packages():
    import paddle_tpu.framework.io as ref_io
    import paddle_tpu.linalg as ref_linalg
    import paddle_tpu.nn.functional as ref_f
    import paddle_tpu_torch.framework.io as port_io

    assert sorted(paddle_tpu_torch.linalg.__all__) == \
        sorted(ref_linalg.__all__)
    assert _public(port_io) == _public(ref_io)
    assert paddle_tpu_torch.save is port_io.save
    assert paddle_tpu_torch.load is port_io.load
    ref_names = {n for n in dir(ref_f) if not n.startswith("_")
                 and callable(getattr(ref_f, n))
                 and getattr(getattr(ref_f, n), "__module__", "")
                 .startswith("paddle_tpu.nn.functional")}
    port_f = paddle_tpu_torch.nn.functional
    assert ref_names <= {n for n in dir(port_f) if not n.startswith("_")}
    assert len(ref_names) == 127 + 6


@pytest.mark.parametrize("name", STATIC_TOGGLES)
def test_a_name_that_waits_raises_naming_its_slice(name):
    """The toggles waited for A10f part 2 and raised; they are ported now:
    each is extras' callable and switches the static recorder."""
    from paddle_tpu_torch.static import graph

    fn = getattr(paddle_tpu_torch, name)
    assert fn is getattr(paddle_tpu_torch.ops.extras, name)
    assert hasattr(paddle_tpu, name)
    try:
        fn()
        assert graph.in_static_graph_mode() == (name == "enable_static")
        assert paddle_tpu_torch.in_dynamic_mode() == (
            name == "disable_static")
    finally:
        paddle_tpu_torch.disable_static()


def test_c_ops_has_the_jax_modules_names_and_signatures():
    from paddle_tpu import _C_ops as ref
    from paddle_tpu_torch import _C_ops as port

    assert port.__all__ == ref.__all__ and len(port.__all__) == 343
    assert port._TARGETS == ref._TARGETS
    for name in ref.__all__:
        assert inspect.signature(getattr(port, name)) == \
            inspect.signature(getattr(ref, name)), name


def test_302_c_ops_targets_resolve_and_the_rest_name_their_slice():
    """302 targets resolved before vision.ops (A10d) came, 322 before
    quantization (A10f part 1); 332 now."""
    from paddle_tpu_torch import _C_ops as port

    resolved, later = 0, {p: 0 for p in C_OPS_LATER}
    for name, target in port._TARGETS.items():
        prefix = next((p for p in C_OPS_LATER if target.startswith(p)),
                      None)
        if prefix is None:
            assert callable(port._t(name)), name
            resolved += 1
            continue
        with pytest.raises(NotImplementedError,
                           match=C_OPS_LATER[prefix][0]):
            port._t(name)
        later[prefix] += 1
    assert resolved == 332
    assert later == {p: n for p, (_, n) in C_OPS_LATER.items()}


def _methods(cls):
    return {n for n in dir(cls) if not n.startswith("__")
            and callable(getattr(cls, n))
            and not isinstance(getattr(cls, n), property)}


def test_every_tensor_method_is_ported_or_listed_for_part_2():
    """The Tensor methods still to port are PART2_TENSOR_METHODS."""
    ref = _methods(RefTensor) - {"_refill"}
    missing = ref - _methods(Tensor)
    assert missing == PART2_TENSOR_METHODS


def test_the_top_level_namespace_carries_the_six_modules():
    """`import paddle_tpu_torch as paddle` gives every op the JAX package's
    top level gives (and their in-place variants), the part-2 modules'
    included; what is missing waits for a later slice."""
    ref_names = {n for n in dir(paddle_tpu) if not n.startswith("_")
                 and callable(getattr(paddle_tpu, n))}
    missing = {n for n in ref_names if not hasattr(paddle_tpu_torch, n)}
    # not ops: the dispatch waist the JAX package's star imports carry
    # along (create_parameter is ported with static, A10f part 2)
    assert missing == {"apply", "apply_multi", "builtins_slice"}
    for n in ("to_tensor", "Tensor", "grad", "no_grad", "seed",
              "set_device", "matmul", "save", "load", "block_diag",
              "batch_fc", "float8_e4m3fn"):
        assert hasattr(paddle_tpu_torch, n), n


# the training API (ROADMAP A10b), vision (A10d), the models and the
# one-card Engine (A10c), jit.save/load and the Predictor (A10e),
# quantization, the profiler, amp.debugging, fleet.recompute and
# incubate.nn (A10f part 1), to_static, dy2static, SOT and paddle.static
# (A10f part 2), the program audits (A10f part 3) and paddle.device (A10g):
# the namespaces the port exports with the JAX package's names, and what
# waits for a later slice, by slice
TRAINING_NAMESPACES = ("nn", "nn.initializer", "nn.utils", "optimizer",
                       "optimizer.lr", "amp", "io", "metric", "hapi",
                       "hapi.callbacks", "vision", "vision.models",
                       "vision.datasets", "vision.transforms",
                       "vision.transforms.functional", "vision.ops",
                       "models", "distributed.engine", "jit",
                       "inference", "quantization", "quantization.ptq_int8",
                       "profiler", "profiler.profiler_statistic",
                       "amp.debugging", "distributed.fleet.recompute",
                       "incubate.nn", "incubate.nn.functional", "static",
                       "static.nn", "jit.dy2static", "jit.sot", "analysis",
                       "device")
TRAINING_LATER = {
    # the mesh, its sharding types and the spec helper: A9
    "distributed.engine": {n: "A9" for n in ("shard_first_free_axis",
                                             "Mesh", "NamedSharding", "P")},
}
# what the port's namespace holds beyond the JAX package's: the functional
# serving models and their bridges, by name
PORT_EXTRA = {
    "models": {"Llama", "LlamaArgs", "LLAMA2_7B", "init_params",
               "params_from_numpy", "generate", "prefill", "decode_step",
               "paged_decode_step", "quantize_params", "QuantizedWeight",
               "QuantizedKVPage", "tree_from_numpy", "adamw_state_from_numpy",
               "tree_to_numpy", "draft_from_params", "Gpt", "GPTGenArgs",
               "gpt_generate", "init_gpt_params", "gpt_params_from_numpy",
               "Bert", "init_bert_params", "bert_params_from_numpy",
               "params_from_layer", "layer_from_numpy",
               "gpt_params_from_layer", "weights"},
    "distributed.engine": {"waits_for"},
    # the walker under its own name (`jaxpr_walk` is bound to it too)
    "analysis": {"graph_walk"},
    # the device resolution every entry point shares
    "device": {"resolve_device", "check_device"},
}


def _names(module):
    """Public names of a namespace, without what it imports only to use:
    foreign modules and the JAX package's Tensor class."""
    out = set()
    for n in dir(module):
        v = getattr(module, n)
        if n.startswith("_") or n == "Tensor" or (
                inspect.ismodule(v) and not v.__name__.startswith(
                    ("paddle_tpu.", "paddle_tpu_torch."))):
            continue
        out.add(n)
    return out


def _resolve(root, path):
    import importlib

    for part in path.split("."):
        if not hasattr(root, part):  # a submodule nothing imported yet
            importlib.import_module(f"{root.__name__}.{part}")
        root = getattr(root, part)
    return root


@pytest.mark.parametrize("path", TRAINING_NAMESPACES)
def test_training_namespace_has_the_jax_packages_names(path):
    import importlib

    ref, port = _resolve(paddle_tpu, path), _resolve(paddle_tpu_torch, path)
    got = _names(port)
    # a submodule shows in a namespace once anything imported it: import
    # the JAX package's counterpart of each the port's shows
    for n in got:
        if inspect.ismodule(getattr(port, n)):
            try:
                importlib.import_module(f"{ref.__name__}.{n}")
            except ImportError:
                pass
    want = _names(ref)
    later = dict(TRAINING_LATER.get(path, {}))
    got = got - PORT_EXTRA.get(path, set())
    assert got == want - set(later), (sorted(want - got), sorted(got - want))
    assert set(later) <= want


# the names of the JAX package's `jit` that raised until ROADMAP A10f part
# 2 ported dynamic-to-static, SOT and their knobs
JIT_LATER = ("to_static", "functionalize", "not_to_static", "ignore_module",
             "TracedLayer", "TranslatedLayer", "StaticFunction",
             "fallback_count", "fallback_report", "symbolic_translate",
             "sot_report", "set_code_level", "set_verbosity",
             "enable_to_static")
# where each one lives in the port (the rest are defined in `jit`)
JIT_HOMES = {"symbolic_translate": "paddle_tpu_torch.jit.sot",
             "sot_report": "paddle_tpu_torch.jit.sot"}


@pytest.mark.parametrize("name", JIT_LATER)
def test_unported_jit_names_raise_naming_a10f(name):
    """Each name is the ported callable: defined in the port's `jit` (or
    `jit.sot`), of the JAX package's kind (a class or a function)."""
    fn = getattr(paddle_tpu_torch.jit, name)
    ref = getattr(paddle_tpu.jit, name)
    assert callable(fn)
    assert fn.__module__ == JIT_HOMES.get(name, "paddle_tpu_torch.jit")
    assert inspect.isclass(fn) == inspect.isclass(ref)
    assert "A10f" not in (fn.__doc__ or "")


def test_distributed_exports_the_engine():
    from paddle_tpu_torch.distributed.engine import Engine

    assert paddle_tpu_torch.distributed.Engine is Engine
    assert "Engine" in paddle_tpu_torch.distributed.__all__
    assert paddle_tpu.distributed.Engine.__name__ == Engine.__name__


@pytest.mark.parametrize("cls", ["nn.Layer", "nn.Parameter", "ParamAttr",
                                 "Model", "optimizer.Optimizer",
                                 "optimizer.AdamW", "optimizer.lr.LRScheduler",
                                 "amp.GradScaler", "io.DataLoader",
                                 "metric.Metric", "hapi.Callback"])
def test_training_classes_have_the_jax_packages_methods(cls):
    ref, port = _resolve(paddle_tpu, cls), _resolve(paddle_tpu_torch, cls)
    names = {n for n in dir(ref) if not n.startswith("__")}
    # the Tensor methods a Parameter inherits are held by the Tensor test;
    # the JAX Tensor's own later-slice methods stay out of Parameter too
    if cls == "nn.Parameter":
        names = set(ref.__slots__)
        assert names <= set(dir(port)) and set(port.__slots__) == names
        return
    missing = names - set(dir(port))
    # the JAX AdamW's eager per-leaf path (`_fuse_step` off): the port
    # computes the fused step's semantics leaf by leaf and has no switch
    if cls == "optimizer.AdamW":
        missing -= {"_adam_update", "_decay", "_update_param"}
    assert not missing, sorted(missing)


def test_flops_and_summary_walk_the_layers():
    from paddle_tpu_torch.framework import device as port_device

    prev = port_device._current
    paddle_tpu_torch.set_device("cpu")
    try:
        net = paddle_tpu_torch.nn.Sequential(paddle_tpu_torch.nn.Linear(4, 3))
        assert paddle_tpu_torch.flops(net, [2, 4]) == 2 * 2 * 4 * 3
        assert paddle_tpu_torch.summary(net)["total_params"] == 15
    finally:
        port_device._current = prev


def test_flags_keep_the_jax_packages_defaults_and_say_they_do_nothing():
    """The flags that still do nothing warn when set; the nan/inf flags act
    since amp.debugging (A10f part 1) and no longer warn."""
    import warnings

    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.core import tensor as core_tensor
    from paddle_tpu_torch.framework import flags

    names = sorted(flags._DEFAULTS)
    assert paddle_tpu_torch.get_flags(names) == paddle_tpu.get_flags(names)
    assert not {"FLAGS_check_nan_inf", "FLAGS_check_nan_inf_level"} & \
        flags.EFFECT_PENDING
    saved = paddle_tpu_torch.get_flags(names)
    try:
        with pytest.warns(UserWarning, match="no effect"):
            paddle_tpu_torch.set_flags({"FLAGS_benchmark": True})
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf": True})
        assert core_tensor._sanitizer is debugging._sanitize_hook
        paddle_tpu_torch.set_flags({"FLAGS_v": 3})  # recorded, no warning
        assert paddle_tpu_torch.get_flags(
            ["FLAGS_check_nan_inf", "FLAGS_v"]) == {
                "FLAGS_check_nan_inf": True, "FLAGS_v": 3}
    finally:
        paddle_tpu_torch.set_flags({"FLAGS_check_nan_inf": False})
        flags._flags.update(saved)
    assert core_tensor._sanitizer is None
    assert flags._from_env("FLAGS_benchmark", "true") is True
    assert flags._from_env("FLAGS_v", "2") == 2
    assert flags._from_env("FLAGS_fraction_of_gpu_memory_to_use",
                           "0.5") == 0.5
