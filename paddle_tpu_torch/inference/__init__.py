"""paddle.inference: the deployment Predictor (`paddle_tpu/inference/
__init__.py`; config 5 of BASELINE; reference
`paddle/fluid/inference/api/analysis_predictor.h:72` AnalysisPredictor,
Python surface `python/paddle/inference/__init__.py:17-51`).

The Predictor serves what `paddle_tpu_torch.jit.save` wrote: it loads the
`torch.export` program from the `.pdmodel` file and the weights from the
`.pdiparams` file, runs the load-time passes over the weights, places
each weight once on the Config's device and keeps it there across `run()`
calls. The program is an fx graph of aten ops and of the port's kernel
ops (B1 as `paddle_tpu_torch::flash_fwd`, B8 as
`paddle_tpu_torch::weight_only_matmul` in a program saved with
`quantize="weight_only_int8"`), each launched as the eager op would
launch it. A program traced on another device is moved with
`torch.export.passes.move_to_device_pass`.

A Config runs on the card (`cuda:<device_id>`) unless `disable_gpu()`
chose the CPU; asking for the card where there is none raises when the
Predictor is built. Nothing falls back to the CPU.
"""

from __future__ import annotations

import io
import os
import pickle
import warnings

import numpy as np
import torch
import torch.utils._pytree as _pytree

__all__ = ["Config", "Predictor", "PredictorHandle", "create_predictor",
           "PrecisionType", "PlaceType", "get_version", "DataType",
           "Tensor", "PredictorPool", "XpuConfig",
           "get_num_bytes_of_data_type", "get_trt_compile_version",
           "get_trt_runtime_version", "convert_to_mixed_precision"]


def get_version():
    import paddle_tpu_torch

    return paddle_tpu_torch.__version__


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1   # the card
    XPU = 2
    CUSTOM = 3


class Config:
    """Subset of AnalysisConfig (`api/paddle_analysis_config.h`)."""

    def __init__(self, prog_file=None, params_file=None):
        if prog_file is not None and params_file is None:
            # directory form: Config("path/prefix")
            prog_file, params_file = prog_file + ".pdmodel", prog_file + ".pdiparams"
        self.prog_file = prog_file
        self.params_file = params_file
        self._device = "cuda"
        self._device_id = 0
        self._precision = PrecisionType.Float32
        self._enable_memory_optim = True
        self._cpu_math_threads = 1
        self._profile = False

    # -- device selection ---------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._device, self._device_id = "cuda", device_id

    def enable_custom_device(self, device_type="gpu", device_id=0,
                             precision=PrecisionType.Float32):
        self._device, self._device_id, self._precision = \
            "cuda", device_id, precision

    def disable_gpu(self):
        self._device = "cpu"

    def _place(self):
        """The torch.device the Predictor runs on; raises when it is the
        card and no card is present."""
        from paddle_tpu_torch.device import resolve_device

        if self._device == "cpu":
            return torch.device("cpu")
        return resolve_device(f"cuda:{self._device_id}")

    def set_model(self, prog_file, params_file=None):
        if params_file is None:
            prog_file, params_file = prog_file + ".pdmodel", prog_file + ".pdiparams"
        self.prog_file, self.params_file = prog_file, params_file

    def model_dir(self):
        return os.path.dirname(self.prog_file or "")

    # -- accepted no-ops; each warns (once a call site, by the warnings
    #    filter) so the acceptance is visible, not silent -------------------
    @staticmethod
    def _noop_warn(name, why):
        warnings.warn(f"inference.Config.{name}() is accepted but is a "
                      f"no-op on this backend: {why}", stacklevel=3)

    def enable_memory_optim(self, x=True):
        self._enable_memory_optim = x
        self._noop_warn("enable_memory_optim",
                        "PyTorch's caching allocator reuses device memory "
                        "across the program's ops unconditionally")

    def switch_ir_optim(self, x=True):
        if not x:
            self._noop_warn("switch_ir_optim(False)",
                            "the exported program runs as it was traced; "
                            "no IR pass runs at load")

    def enable_mkldnn(self):
        self._noop_warn("enable_mkldnn",
                        "the CPU runs PyTorch's own CPU kernels")

    def set_cpu_math_library_num_threads(self, n):
        self._cpu_math_threads = n
        self._noop_warn("set_cpu_math_library_num_threads",
                        "PyTorch's intra-op thread pool is process-global "
                        "(torch.set_num_threads)")

    def enable_profile(self):
        """Turn on run-level profiling: the Predictor records wall time and
        call counts into a serving.metrics registry, retrievable via
        `Predictor.summary()`. A profiled run waits for the card at its
        end, so the recorded wall time covers the device's work."""
        self._profile = True

    def glog_info_disabled(self):
        return True

    def switch_use_feed_fetch_ops(self, x=False):
        pass  # feed/fetch ops do not exist in the exported program

    def switch_specify_input_names(self, x=True):
        pass  # input names always ride the save

    def enable_tensorrt_engine(self, *a, **k):
        self._noop_warn("enable_tensorrt_engine",
                        "there is no TensorRT here; the program runs the "
                        "port's kernels and PyTorch's")

    # -- load-time passes (reference AnalysisConfig::pass_builder,
    #    `api/paddle_pass_builder.cc`) ---------------------------------------
    def pass_builder(self):
        if not hasattr(self, "_pass_strategy"):
            self._pass_strategy = PassStrategy()
        return self._pass_strategy

    def delete_pass(self, name):
        self.pass_builder().delete_pass(name)

    def summary(self):
        return (f"Config(prog={self.prog_file}, params={self.params_file}, "
                f"device={self._device}, "
                f"passes={self.pass_builder().all_passes()})")


class PassStrategy:
    """reference `PaddlePassBuilder` (`api/paddle_pass_builder.h`): an
    ordered, editable pass list. The passes run at load over the weights;
    the built-in entries name what the program already is: functionalized
    by `torch.export` at save, with each attention on B1's gate one fused
    kernel op and each weight-only int8 Linear one B8 op. They cannot be
    deleted; deleting one warns."""

    _BUILTIN = ("torch_export_functionalization", "flash_attention_op",
                "weight_only_matmul_op")
    _DEFAULT = ("weight_dedup_pass",)
    _AVAILABLE = ("weight_dedup_pass", "bf16_weights_pass")

    def __init__(self):
        self._passes = list(self._DEFAULT)

    def all_passes(self):
        return list(self._BUILTIN) + list(self._passes)

    def delete_pass(self, name):
        if name in self._passes:
            self._passes.remove(name)
        elif name in self._BUILTIN:
            warnings.warn(f"pass {name!r} is part of the saved program and "
                          "cannot be deleted", stacklevel=2)

    def append_pass(self, name):
        if name not in self._AVAILABLE:
            raise ValueError(
                f"unknown pass {name!r}; available: {self._AVAILABLE}")
        if name not in self._passes:
            self._passes.append(name)

    def insert_pass(self, idx, name):
        self.append_pass(name)


class PredictorHandle:
    """Input/output handle (reference ZeroCopyTensor,
    `paddle/fluid/inference/api/details/zero_copy_tensor.cc`). An output
    handle holds a device tensor; `copy_to_cpu` copies it to the host (a
    bf16 one as its uint16 bits, as `Tensor.numpy()` gives it)."""

    def __init__(self, name):
        self.name = name
        self._array = None

    def reshape(self, shape):
        pass  # shapes come from the bound array

    def copy_from_cpu(self, arr):
        self._array = np.ascontiguousarray(arr)

    def share_external_data(self, arr):
        self._array = arr if isinstance(arr, torch.Tensor) else np.asarray(arr)

    def copy_to_cpu(self):
        if isinstance(self._array, torch.Tensor):
            from paddle_tpu_torch.core.tensor import Tensor as _Tensor

            return _Tensor(self._array).numpy()
        return np.asarray(self._array)

    def shape(self):
        return list(self._array.shape) if self._array is not None else []


def _load_program(meta, prog_file):
    """The ExportedProgram of a `.pdmodel` dict; raises ValueError naming
    `paddle_tpu_torch.jit.save` when the file holds none."""
    from paddle_tpu_torch.jit import _PROGRAM_KEY

    if not isinstance(meta, dict) or _PROGRAM_KEY not in meta:
        held = (" (it holds only a StableHLO program, which the JAX "
                "package's jit.save writes)"
                if isinstance(meta, dict) and "stablehlo" in meta else "")
        raise ValueError(
            f"{prog_file} has no program the port can run{held}; re-save "
            "with paddle_tpu_torch.jit.save(layer, path, input_spec=[...])")
    # the kernels' custom ops must be registered before the program loads
    from paddle_tpu_torch.kernels import (  # noqa: F401
        flash_attention, quantized_matmul, rms_norm)
    from paddle_tpu_torch.quantization import ptq_int8  # noqa: F401

    return torch.export.load(io.BytesIO(meta[_PROGRAM_KEY]))


class Predictor:
    """Predictor over a `torch.export` program saved by `jit.save`."""

    def __init__(self, config: Config):
        from paddle_tpu_torch.jit import _read_params

        self.config = config
        dev = config._place()
        with open(config.prog_file, "rb") as f:
            meta = pickle.load(f)
        ep = _load_program(meta, config.prog_file)
        if torch.device(meta["device"]) != dev:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, dev)
        self.device = dev
        self._module = ep.module()
        self._input_names = meta["input_names"]
        self._output_names = meta.get("output_names") or ["output_0"]
        self._param_keys = meta["param_keys"]
        state = _read_params(config.params_file)
        params = [state[k] for k in self._param_keys]
        # the dtypes the program was traced with: a pass or a converted
        # file may store a weight in another, and run() casts it back
        vals = {n.name: n.meta["val"] for n in ep.graph.nodes
                if n.op == "placeholder"}
        self._param_dtypes = [vals[n].dtype for n in
                              ep.graph_signature.user_inputs[:len(params)]]
        params = self._apply_passes(config, params)
        placed = {}
        self._params = []
        for a in params:
            # aliased (deduped) weights are placed once and share a buffer
            if id(a) not in placed:
                placed[id(a)] = a.to(dev)
            self._params.append(placed[id(a)])
        self._inputs = {n: PredictorHandle(n) for n in self._input_names}
        self._outputs = {n: PredictorHandle(n) for n in self._output_names}
        from paddle_tpu_torch.framework.dtypes import convert_dtype

        self._input_dtypes = [convert_dtype(d) for d in meta["input_dtypes"]]
        if getattr(config, "_profile", False):
            from paddle_tpu_torch.serving.metrics import Metrics

            self._profile_metrics = Metrics()
        else:
            self._profile_metrics = None

    def _apply_passes(self, config, params):
        """Run the load-time analysis passes (reference
        `AnalysisPredictor::OptimizeInferenceProgram`,
        `analysis_predictor.cc`) over the host weights."""
        names = config.pass_builder()._passes
        if "weight_dedup_pass" in names:
            # alias byte-identical weights (tied embeddings exported twice):
            # one host copy -> one device buffer. Group by (shape, dtype)
            # first so singletons never pay the content hash.
            groups = {}
            for i, a in enumerate(params):
                groups.setdefault((tuple(a.shape), a.dtype), []).append(i)
            for idxs in groups.values():
                if len(idxs) < 2:
                    continue
                seen = {}
                for i in idxs:
                    a = params[i]
                    h = hash(a.contiguous().reshape(-1).view(torch.uint8)
                             .numpy().tobytes())
                    j = seen.get(h)
                    if j is not None and torch.equal(params[j], a):
                        params[i] = params[j]
                    else:
                        seen[h] = i
        # bf16_weights_pass: halve the weights' device bytes; run() casts
        # back to the program's dtype on the fly. The cast goes through an
        # id()-keyed memo: a fresh tensor per aliased entry would undo the
        # dedup above (placement keys on id), so tied weights still share
        # one device buffer after both passes.
        if "bf16_weights_pass" in names:
            memo = {}

            def cast(a):
                out = memo.get(id(a))
                if out is None:
                    out = (a.to(torch.bfloat16) if a.dtype == torch.float32
                           else a)
                    memo[id(a)] = out
                return out

            params = [cast(a) for a in params]
        return params

    def get_input_names(self):
        return list(self._input_names)

    def get_output_names(self):
        return list(self._output_names)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_handle(self, name):
        return self._outputs[name]

    def _feed(self, arr, dtype):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        return t.to(self.device).to(dtype)

    def _call(self):
        feeds = [self._feed(self._inputs[n]._array, dt)
                 for n, dt in zip(self._input_names, self._input_dtypes)]
        params = [p if p.dtype == dt else p.to(dt)
                  for p, dt in zip(self._params, self._param_dtypes)]
        with torch.no_grad():
            return self._module(params, feeds)

    def run(self, inputs=None):
        """AnalysisPredictor::Run / ZeroCopyRun (`analysis_predictor.cc:1574,2577`).

        Outputs stay on the device (torch tensors, launched asynchronously
        on the card): the host copy happens in the output handle's
        `copy_to_cpu`, so back-to-back run() calls queue without a sync."""
        if inputs is not None:  # positional list form
            for h, arr in zip(self._inputs.values(), inputs):
                h.share_external_data(arr)
        if self._profile_metrics is not None:
            with self._profile_metrics.timer("run_wall_s"):
                out = self._call()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self._profile_metrics.inc("run_calls")
        else:
            out = self._call()
        outs = _pytree.tree_leaves(out)
        results = []
        for name, o in zip(self._output_names, outs):
            self._outputs[name]._array = o
            results.append(o)
        return results

    def summary(self):
        """Profile summary when `Config.enable_profile()` was set: wall-time
        observation (count/sum/mean/min/max seconds) + run_calls counter
        from the serving metrics layer. None when profiling is off."""
        if self._profile_metrics is None:
            return None
        return self._profile_metrics.summary()


def create_predictor(config: Config) -> Predictor:
    return Predictor(config)


class DataType:
    """reference inference.DataType enum."""

    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6
    BOOL = 7
    FLOAT64 = 8


_DTYPE_NBYTES = {DataType.FLOAT32: 4, DataType.INT64: 8, DataType.INT32: 4,
                 DataType.UINT8: 1, DataType.INT8: 1, DataType.FLOAT16: 2,
                 DataType.BFLOAT16: 2, DataType.BOOL: 1, DataType.FLOAT64: 8}


def get_num_bytes_of_data_type(dtype):
    return _DTYPE_NBYTES[dtype]


Tensor = PredictorHandle  # reference inference.Tensor == the io handle


class XpuConfig:
    """Accepted-for-compat XPU knob bag (no XPU on this backend)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class PredictorPool:
    """N independent Predictors over one Config (reference
    `inference/api/paddle_inference_api.h` PredictorPool). Each
    retrieve(i) gets its own handles and its own copy of the weights."""

    def __init__(self, config, size=1):
        self._preds = [Predictor(config) for _ in range(max(1, size))]

    def retrieve(self, idx):
        return self._preds[idx]


def get_trt_compile_version():
    return (0, 0, 0)  # no TensorRT on this backend


def get_trt_runtime_version():
    return (0, 0, 0)


def convert_to_mixed_precision(model_file, params_file, mixed_model_file,
                               mixed_params_file, mixed_precision=None,
                               backend=None, keep_io_types=True,
                               black_list=None, **kw):
    """Offline fp32 -> bf16/fp16 weight conversion of a saved predictor
    (reference `inference/convert_to_mixed_precision`): rewrites the
    .pdiparams weights and copies the .pdmodel program; the Predictor
    casts each weight back to the program's dtype at run."""
    import shutil

    from paddle_tpu_torch.framework.io import _host_array
    from paddle_tpu_torch.jit import _read_params

    targets = {None: torch.float16, PrecisionType.Half: torch.float16,
               PrecisionType.Bfloat16: torch.bfloat16}
    if mixed_precision not in targets:
        raise ValueError(
            f"convert_to_mixed_precision: unsupported mixed_precision "
            f"{mixed_precision!r} (Half or Bfloat16)")
    target = targets[mixed_precision]
    bl = set(black_list or ())
    out = {}
    for k, v in _read_params(params_file).items():
        if k not in bl and v.dtype == torch.float32:
            v = v.to(target)
        out[k] = _host_array(v)
    with open(mixed_params_file, "wb") as f:
        pickle.dump(out, f)
    shutil.copyfile(model_file, mixed_model_file)


def _get_phi_kernel_name(op_name):
    return op_name  # one dispatch waist: the op name IS the kernel name
