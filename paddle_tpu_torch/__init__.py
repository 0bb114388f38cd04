"""paddle_tpu_torch — the PyTorch/CUDA port of `paddle_tpu`.

The JAX package `paddle_tpu` is the reference; this package grows beside
it slice by slice, for one NVIDIA H100. It imports `torch` and never JAX
or anything of `paddle_tpu`.

Layout (slices so far: paged-KV and int8 Llama serving, single-card
training):

  - `device`: device resolution — entry points run on CUDA unless the
    caller passes `device="cpu"`, and raise when no card is present;
  - `models/`: the functional Llama (`llama_functional`, with the
    training forward and loss), the weights module (`llama.Llama`),
    generation (`generation`) and the bridge from the JAX parameter and
    optimizer trees (`weights`);
  - `distributed/`: `HybridParallelEngine` on one card and its AdamW;
  - `core/`: nested-dict trees and stochastic rounding;
  - `kernels/`: hand-written CUDA kernels for Hopper (`csrc/`), their
    build (`_build`) and their wrappers with plain PyTorch versions
    (`attention`, `quantized_matmul`, `flash_attention`);
  - `serving/`: the stripe `Engine` and the paged `PagedEngine` with the
    radix prefix cache, scheduler, sampler and metrics;
  - `observability/registry`: the metrics registry serving reports to.
"""

from paddle_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
