"""Llama: functional building blocks and the training forward and loss,
the weights module, the layer-built `LlamaForCausalLM` (with
`params_from_layer` into the functional tree), generation over stripe
and paged caches, weight-only int8 quantization, and the bridge from the
JAX parameter and optimizer trees (and from a JAX layer's state dict,
`layer_from_numpy`). GPT-2 (`models/gpt.py`: the cached forward, `gpt_generate`, the
layer-built `GPTForCausalLM` and `gpt_params_from_layer`) and BERT
(`models/bert.py`: the serving encoder and the layer-built
`BertForPretraining`), with their bridges from the JAX trees. The
diffusion UNet (`models/unet.py`), BASELINE config 5."""

from paddle_tpu_torch.models.generation import (QuantizedKVPage,
                                                QuantizedWeight, decode_step,
                                                draft_from_params, generate,
                                                paged_decode_step,
                                                params_from_layer, prefill,
                                                quantize_params)
from paddle_tpu_torch.models.bert import (Bert, BertConfig,
                                          BertForPretraining, BertModel,
                                          BertPretrainingLoss, bert_base,
                                          bert_tiny, init_bert_params)
from paddle_tpu_torch.models.gpt import (Gpt, GPTConfig, GPTForCausalLM,
                                         GPTGenArgs, GPTModel,
                                         GPTPretrainingLoss, gpt_generate,
                                         gpt_params_from_layer,
                                         gpt_pipeline_descs, gpt_tiny,
                                         init_gpt_params)
from paddle_tpu_torch.models.llama import (Llama, LlamaAttention,
                                           LlamaConfig, LlamaDecoderLayer,
                                           LlamaForCausalLM, LlamaMLP,
                                           LlamaModel,
                                           LlamaPretrainingCriterion,
                                           LlamaRMSNorm,
                                           LlamaRotaryEmbedding)
from paddle_tpu_torch.models.llama_functional import (LLAMA2_7B, LlamaArgs,
                                                      init_params)
from paddle_tpu_torch.models import unet  # noqa: F401
from paddle_tpu_torch.models.unet import UNetModel, unet_sd_like, unet_tiny
from paddle_tpu_torch.models.weights import (adamw_state_from_numpy,
                                             bert_params_from_numpy,
                                             gpt_params_from_numpy,
                                             layer_from_numpy,
                                             params_from_numpy,
                                             tree_from_numpy, tree_to_numpy)

__all__ = ["Llama", "LlamaArgs", "LLAMA2_7B", "init_params",
           "params_from_numpy", "generate", "prefill", "decode_step",
           "paged_decode_step", "quantize_params", "QuantizedWeight",
           "QuantizedKVPage", "tree_from_numpy", "adamw_state_from_numpy",
           "tree_to_numpy", "draft_from_params", "Gpt", "GPTConfig",
           "GPTGenArgs", "gpt_generate", "init_gpt_params",
           "gpt_params_from_numpy", "Bert", "BertConfig", "init_bert_params",
           "bert_params_from_numpy", "LlamaConfig", "LlamaForCausalLM",
           "params_from_layer", "layer_from_numpy", "LlamaRMSNorm",
           "LlamaRotaryEmbedding", "LlamaAttention", "LlamaMLP",
           "LlamaDecoderLayer", "LlamaModel", "LlamaPretrainingCriterion",
           "BertForPretraining",
           "BertModel", "BertPretrainingLoss", "bert_base", "bert_tiny",
           "GPTForCausalLM", "GPTModel", "GPTPretrainingLoss",
           "gpt_pipeline_descs", "gpt_tiny", "gpt_params_from_layer",
           "UNetModel", "unet_tiny", "unet_sd_like"]
