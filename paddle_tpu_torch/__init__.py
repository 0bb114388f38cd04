"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`.

The JAX package `paddle_tpu` is the reference; this package grows beside
it slice by slice, for one NVIDIA H100. It imports `torch` and never JAX
or anything of `paddle_tpu`.

    import paddle_tpu_torch as paddle
    paddle.set_device('gpu')
    x = paddle.randn([4, 8]); y = paddle.matmul(x, x.T)

Layout (slices so far: paged-KV and int8 Llama serving, single-card
training, the eager Tensor and its op surface, the layers and the
training API):

  - `device`: device resolution — entry points run on CUDA unless the
    caller passes `device="cpu"`, and raise when no card is present;
  - `models/`: the functional Llama (`llama_functional`, with the
    training forward and loss), the weights module (`llama.Llama`),
    generation (`generation`) and the bridge from the JAX parameter and
    optimizer trees (`weights`);
  - `distributed/`: `HybridParallelEngine` on one card and its AdamW;
    process groups, the collectives, `DataParallel` (also
    `paddle.DataParallel`) and the `fleet` entry over `torch.distributed`
    (NCCL on the card, gloo on the CPU), one process per rank;
  - `core/`: nested-dict trees and stochastic rounding;
  - `kernels/`: hand-written CUDA kernels for Hopper (`csrc/`), their
    build (`_build`) and their wrappers with plain PyTorch versions
    (`attention`, `quantized_matmul`, `flash_attention`);
  - `serving/`: the stripe `Engine` and the paged `PagedEngine` with the
    radix prefix cache, scheduler, sampler and metrics;
  - `observability/registry`: the metrics registry serving reports to;
  - the eager surface: `core/tensor` (`Tensor` over a torch.Tensor, with
    torch's autograd), `core/backward`, `autograd`, `framework/` (dtypes,
    device, flags, RNG), `ops/` (creation, math, manipulation, logic,
    search, linalg, extras, legacy_ps), `nn.functional` (with flash
    attention on B1-B3 and `rms_norm` on B9/B10), the `linalg` and `fft`
    namespaces, `save`/`load` (`framework/io`), `_C_ops` and the native
    core (`core/native`: TCPStore, flags, watchdog), re-exported here as
    `paddle_tpu/__init__.py` does;
  - the training API: `nn` (layers, initializers, utils, `ClipGrad*`),
    `optimizer` (14 optimizers, 15 LR schedulers), `amp` (auto_cast on
    the dispatch waist, decorate, GradScaler), `io` (datasets, samplers,
    DataLoader with worker processes), `metric`, `hapi` (`Model`),
    `vision` (the model zoo, datasets, transforms, ops), the layer-built
    Llama, GPT and BERT (`models`), and `distributed.Engine`, the
    model-generic trainer on one card;
  - deployment: the diffusion UNet (`models/unet`), `jit.save`/`jit.load`
    (a `torch.export` program with the weights as its inputs) and the
    `inference` Predictor that serves it; `quantization` (fake quant,
    weight-only int8 on B8, activation-int8 PTQ) and `jit.save(quantize=)`;
  - tooling and fused layers: `amp.debugging` (the nan/inf checker and
    operator stats on the dispatch waist), `profiler` (over
    `torch.profiler`), `distributed.fleet.recompute` and `incubate.nn`;
  - `signal` (frame, overlap_add, stft/istft over `torch.fft`),
    `geometric` (segment reductions, message passing, the host-side
    samplers) with incubate's graph ops, `sparse` (COO/CSR over torch's
    sparse layouts) and `distribution` (the 27 names of the JAX module).
"""

from paddle_tpu_torch.device import resolve_device  # noqa: F401

from paddle_tpu_torch.framework.dtypes import (  # noqa: F401
    bfloat16, bool_, complex128, complex64, float16, float32, float64,
    get_default_dtype, int16, int32, int64, int8, set_default_dtype, uint8,
)

bool = bool_  # paddle.bool

from paddle_tpu_torch.framework.device import (  # noqa: F401,E402
    device_count, get_device, is_compiled_with_cuda, is_compiled_with_rocm,
    is_compiled_with_xpu, is_compiled_with_custom_device, set_device,
    get_all_custom_device_type,
)
from paddle_tpu_torch.framework.flags import get_flags, set_flags  # noqa: F401,E402
from paddle_tpu_torch.framework.random import (  # noqa: F401,E402
    get_cuda_rng_state, get_rng_state, seed, set_cuda_rng_state,
    set_rng_state)

from paddle_tpu_torch.core.tensor import (  # noqa: F401,E402
    Tensor, to_tensor, no_grad, enable_grad, is_grad_enabled,
    set_grad_enabled,
)
from paddle_tpu_torch.core.backward import grad  # noqa: F401,E402

from paddle_tpu_torch.ops.creation import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.math import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.manipulation import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.linalg import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.logic import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.search import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.legacy_ps import *  # noqa: F401,F403,E402
from paddle_tpu_torch.ops.extras import *  # noqa: F401,F403,E402

from paddle_tpu_torch.core import ops_patch as _ops_patch  # noqa: E402

_ops_patch.install()

from paddle_tpu_torch import autograd  # noqa: F401,E402
from paddle_tpu_torch import framework  # noqa: F401,E402
from paddle_tpu_torch import nn  # noqa: F401,E402
from paddle_tpu_torch import optimizer  # noqa: F401,E402
from paddle_tpu_torch import io  # noqa: F401,E402
from paddle_tpu_torch import metric  # noqa: F401,E402
from paddle_tpu_torch import amp  # noqa: F401,E402
from paddle_tpu_torch import vision  # noqa: F401,E402
from paddle_tpu_torch import distributed  # noqa: F401,E402
from paddle_tpu_torch.distributed import DataParallel  # noqa: F401,E402
from paddle_tpu_torch import hapi  # noqa: F401,E402
from paddle_tpu_torch.hapi.model import Model  # noqa: F401,E402
from paddle_tpu_torch.nn.layer.layers import ParamAttr  # noqa: F401,E402
from paddle_tpu_torch.framework.io import save, load  # noqa: F401,E402
from paddle_tpu_torch import fft, linalg  # noqa: F401,E402
from paddle_tpu_torch import jit, inference  # noqa: F401,E402
from paddle_tpu_torch import quantization, profiler, incubate  # noqa: F401,E402
from paddle_tpu_torch import static  # noqa: F401,E402
from paddle_tpu_torch import signal, geometric  # noqa: F401,E402
from paddle_tpu_torch import sparse, distribution  # noqa: F401,E402


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None):
    """paddle.create_parameter: `static.create_parameter`, an eagerly made
    Parameter."""
    return static.create_parameter(shape, dtype, name=name, attr=attr,
                                   is_bias=is_bias,
                                   default_initializer=default_initializer)


_ops_patch._install_inplace_variants()

from paddle_tpu_torch.core.tensor_methods import \
    install_tensor_methods as _itm  # noqa: E402

_itm()
del _itm

__version__ = "0.1.0"
