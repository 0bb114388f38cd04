"""Llama: functional building blocks and the training forward and loss,
the weights module, generation over stripe and paged caches, weight-only
int8 quantization, and the bridge from the JAX parameter and optimizer
trees."""

from paddle_tpu_torch.models.generation import (QuantizedKVPage,
                                                QuantizedWeight, decode_step,
                                                draft_from_params, generate,
                                                paged_decode_step, prefill,
                                                quantize_params)
from paddle_tpu_torch.models.llama import Llama
from paddle_tpu_torch.models.llama_functional import (LLAMA2_7B, LlamaArgs,
                                                      init_params)
from paddle_tpu_torch.models.weights import (adamw_state_from_numpy,
                                             params_from_numpy,
                                             tree_from_numpy, tree_to_numpy)

__all__ = ["Llama", "LlamaArgs", "LLAMA2_7B", "init_params",
           "params_from_numpy", "generate", "prefill", "decode_step",
           "paged_decode_step", "quantize_params", "QuantizedWeight",
           "QuantizedKVPage", "tree_from_numpy", "adamw_state_from_numpy",
           "tree_to_numpy", "draft_from_params"]
