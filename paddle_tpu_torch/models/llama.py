"""Llama: `Llama`, the torch nn.Module that owns a functional parameter tree
(serving and generation), and the layer-built `LlamaForCausalLM` over the
port's `nn.Layer`s (`paddle_tpu/models/llama.py`), for training through
the Paddle API.

`Llama`:

The weights stay in the reference layout (`llama_functional`): [in, out]
matrices, decoder-layer leaves stacked on a leading [num_layers] dim. The
forward functions are `models.generation`'s; the module holds the weights
and the config they run with.

A leaf is a float tensor or, in a weight-only int8 tree
(`generation.quantize_params`), a `QuantizedWeight`: its int8 codes and
f32 scales are the parameters `<key>_q` and `<key>_scale`, and the leaf
reads back as a QuantizedWeight of the two (`lm_head`, `layer(i)`,
`tree()`). The embedding, the norms and every float matmul weight share
one dtype, the compute dtype.
"""

from __future__ import annotations

import torch
from torch import nn

from paddle_tpu_torch.models import generation
from paddle_tpu_torch.models.generation import QuantizedWeight
from paddle_tpu_torch.models.llama_functional import LAYER_KEYS, LlamaArgs

__all__ = ["Llama", "LlamaConfig", "LlamaRMSNorm", "LlamaRotaryEmbedding",
           "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer", "LlamaModel",
           "LlamaForCausalLM", "LlamaPretrainingCriterion"]


def _param(t):
    return nn.Parameter(t, requires_grad=False)


def _entries(key, leaf):
    """{name: Parameter} of one leaf: the tensor under its key, or a
    QuantizedWeight's codes and scales under `<key>_q` and `<key>_scale`."""
    if isinstance(leaf, QuantizedWeight):
        if leaf.q.dtype != torch.int8 or leaf.scale.dtype != torch.float32:
            raise ValueError(f"{key}: a QuantizedWeight holds int8 codes "
                             "and float32 scales")
        return {f"{key}_q": _param(leaf.q),
                f"{key}_scale": _param(leaf.scale)}
    return {key: _param(leaf)}


def _leaf(store, key):
    if key in store:
        return store[key]
    return QuantizedWeight(store[f"{key}_q"], store[f"{key}_scale"])


class Llama(nn.Module):
    """Inference weights of a Llama decoder (no gradients).

    params: a tree as `llama_functional.init_params` returns it (or as
    `generation.quantize_params` returns it), of tensors on one device.
    """

    def __init__(self, args: LlamaArgs, params):
        super().__init__()
        self.args = args
        if set(params["layers"]) != set(LAYER_KEYS):
            raise ValueError(f"layer keys {sorted(params['layers'])} != "
                             f"{sorted(LAYER_KEYS)}")
        leaves = [params["embedding"], params["final_norm"],
                  params["lm_head"], *params["layers"].values()]
        floats = [t for t in leaves if not isinstance(t, QuantizedWeight)]
        tensors = floats + [t for v in leaves
                            if isinstance(v, QuantizedWeight) for t in v]
        if len({t.device for t in tensors}) != 1 or \
                len({t.dtype for t in floats}) != 1:
            raise ValueError("parameters must share one device, and the "
                             "float ones one dtype")
        self.embedding = _param(params["embedding"])
        self.layers = nn.ParameterDict(
            {n: t for k in LAYER_KEYS
             for n, t in _entries(k, params["layers"][k]).items()})
        self.final_norm = _param(params["final_norm"])
        for n, t in _entries("lm_head", params["lm_head"]).items():
            setattr(self, n, t)
        self._check_shapes()

    def __getattr__(self, name):
        # a quantized lm_head is stored as lm_head_q and lm_head_scale
        if name == "lm_head":
            try:
                return _leaf(self._parameters, name)
            except KeyError:
                raise AttributeError(name) from None
        return super().__getattr__(name)

    def _check_shapes(self):
        a = self.args
        h, hd, L = a.hidden_size, a.head_dim, a.num_layers
        want = {"embedding": (a.vocab_size, h), "final_norm": (h,),
                "lm_head": (h, a.vocab_size),
                "wq": (L, h, a.num_heads * hd),
                "wk": (L, h, a.num_kv_heads * hd),
                "wv": (L, h, a.num_kv_heads * hd),
                "wo": (L, a.num_heads * hd, h),
                "w_gate": (L, h, a.intermediate_size),
                "w_up": (L, h, a.intermediate_size),
                "w_down": (L, a.intermediate_size, h),
                "ln1": (L, h), "ln2": (L, h)}
        tree = self.tree()
        have = {"embedding": tree["embedding"],
                "final_norm": tree["final_norm"],
                "lm_head": tree["lm_head"], **tree["layers"]}
        for k, shape in want.items():
            leaf = have[k]
            got = tuple(leaf.q.shape if isinstance(leaf, QuantizedWeight)
                        else leaf.shape)
            if got != shape:
                raise ValueError(f"{k}: shape {got}, the config wants "
                                 f"{shape}")
            if isinstance(leaf, QuantizedWeight) and \
                    tuple(leaf.scale.shape) != shape[:-2] + shape[-1:]:
                raise ValueError(f"{k}: scale {tuple(leaf.scale.shape)} is "
                                 f"not {shape[:-2] + shape[-1:]}")

    @property
    def quantized(self):
        """True when a matmul weight is int8 (a QuantizedWeight)."""
        return any(n.endswith("_q") for n, _ in self.named_parameters())

    @property
    def device(self):
        return self.embedding.device

    @property
    def dtype(self):
        """The compute dtype: the embedding's."""
        return self.embedding.dtype

    def tree(self):
        """The parameter tree these weights came from (the same tensors;
        an int8 leaf as a QuantizedWeight)."""
        return {"embedding": self.embedding,
                "layers": {k: _leaf(self.layers, k) for k in LAYER_KEYS},
                "final_norm": self.final_norm, "lm_head": self.lm_head}

    def layer(self, i):
        """Layer i's weights as a dict of views."""
        return {k: (QuantizedWeight(v.q[i], v.scale[i])
                    if isinstance(v, QuantizedWeight) else v[i])
                for k, v in self.tree()["layers"].items()}

    def forward(self, ids, caches_k, caches_v, pos, cos, sin, last_idx=None):
        """`generation._forward_cached`: next-token logits [b, vocab] f32;
        the caches are written in place."""
        return generation._forward_cached(self, ids, caches_k, caches_v, pos,
                                          cos, sin, last_idx)

    def paged_decode(self, ids, pool_k, pool_v, block_tables, pos, cos, sin,
                     page_size):
        """`generation._paged_forward_decode`: one decode step over the
        page pool (written in place)."""
        return generation._paged_forward_decode(
            self, ids, pool_k, pool_v, block_tables, pos, cos, sin, page_size)


# --------------------------------------------------------------------------
# the layer-built Llama (`paddle_tpu/models/llama.py`)
#
# The JAX package's LlamaForCausalLM over the port's nn.Linear /
# nn.Embedding / nn.LayerList, with the same structured names and [in, out]
# weights, so a JAX state dict loads as it is (`weights.layer_from_numpy`).
# On the card and on the kernels' gates: `LlamaAttention` runs
# `F.flash_attention(causal=True)`, kernel B1 forward and B2/B3 backward;
# `LlamaRMSNorm` runs `F.rms_norm`, B9 forward and B10 backward (the JAX
# layer's own composite rounds as B9 does). Not ported here: the
# tensor-parallel branches (fleet's parallel layers, ROADMAP A9). With
# `recompute`, each decoder layer's block runs under `fleet.recompute`.
# --------------------------------------------------------------------------

import paddle_tpu_torch as paddle  # noqa: E402
from paddle_tpu_torch import nn as pnn  # noqa: E402
from paddle_tpu_torch.core.tensor import Tensor, apply  # noqa: E402
from paddle_tpu_torch.framework import device as _device  # noqa: E402
from paddle_tpu_torch.models import llama_functional as lf  # noqa: E402
from paddle_tpu_torch.nn import functional as F  # noqa: E402


class LlamaConfig:
    """Hyperparameters (mirrors the reference test model's config surface)."""

    def __init__(
        self,
        vocab_size=32000,
        hidden_size=4096,
        intermediate_size=11008,
        num_hidden_layers=32,
        num_attention_heads=32,
        num_key_value_heads=None,
        max_position_embeddings=4096,
        rms_norm_eps=1e-6,
        rope_theta=10000.0,
        use_flash_attention=True,
        sequence_parallel=False,
        recompute=False,
        tie_word_embeddings=False,
        dtype="float32",
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.use_flash_attention = use_flash_attention
        self.sequence_parallel = sequence_parallel
        self.recompute = recompute
        self.tie_word_embeddings = tie_word_embeddings
        self.dtype = dtype

    @staticmethod
    def llama2_7b(**kw):
        """Llama-2-7B's widths; a keyword overrides any field, depth too
        (the JAX package's raises TypeError on num_hidden_layers)."""
        base = dict(vocab_size=32000, hidden_size=4096,
                    intermediate_size=11008, num_hidden_layers=32,
                    num_attention_heads=32)
        return LlamaConfig(**{**base, **kw})

    @staticmethod
    def tiny(**kw):
        """Small config for tests/benchmarks."""
        kw.setdefault("vocab_size", 512)
        kw.setdefault("hidden_size", 128)
        kw.setdefault("intermediate_size", 352)
        kw.setdefault("num_hidden_layers", 4)
        kw.setdefault("num_attention_heads", 4)
        kw.setdefault("max_position_embeddings", 256)
        return LlamaConfig(**kw)


class LlamaRMSNorm(pnn.Layer):
    """RMS norm in fp32 accumulation: (h32 * rsqrt(mean(h32^2) + eps))
    cast to h's dtype, times the weight; `F.rms_norm` (B9/B10 on the
    card)."""

    def __init__(self, hidden_size, eps=1e-6):
        super().__init__()
        self.weight = self.create_parameter(
            [hidden_size], default_initializer=pnn.initializer.Constant(1.0))
        self.variance_epsilon = eps

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.variance_epsilon)


class LlamaRotaryEmbedding(pnn.Layer):
    def __init__(self, head_dim, max_position_embeddings=4096, theta=10000.0):
        super().__init__()
        self.head_dim = head_dim
        self.max_position_embeddings = max_position_embeddings
        self.theta = theta
        self._cache = {}  # (seq_len, device) -> (cos Tensor, sin Tensor), f32

    def forward(self, seq_len, device=None):
        dev = device if device is not None else _device.place()
        if not isinstance(seq_len, int):
            # a symbolic length (torch.export with a dynamic sequence
            # dimension): the tables become part of the traced program
            cos, sin = lf.rope_tables(seq_len, self.head_dim, self.theta, dev)
            return Tensor(cos), Tensor(sin)
        key = (seq_len, dev)
        if key not in self._cache:
            cos, sin = lf.rope_tables(seq_len, self.head_dim, self.theta, dev)
            self._cache[key] = (Tensor(cos), Tensor(sin))
        return self._cache[key]


class LlamaAttention(pnn.Layer):
    """Multi-head (optionally grouped-query) causal self-attention with RoPE."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.q_proj = pnn.Linear(self.hidden_size, self.num_heads * self.head_dim,
                                 bias_attr=False)
        self.k_proj = pnn.Linear(self.hidden_size, self.num_kv_heads * self.head_dim,
                                 bias_attr=False)
        self.v_proj = pnn.Linear(self.hidden_size, self.num_kv_heads * self.head_dim,
                                 bias_attr=False)
        self.o_proj = pnn.Linear(self.num_heads * self.head_dim, self.hidden_size,
                                 bias_attr=False)
        self.rotary_emb = LlamaRotaryEmbedding(
            self.head_dim, config.max_position_embeddings, config.rope_theta)

    def forward(self, hidden_states, attention_mask=None, position_ids=None,
                past_key_value=None, use_cache=False):
        b, s = hidden_states.shape[0], hidden_states.shape[1]
        q = self.q_proj(hidden_states)
        k = self.k_proj(hidden_states)
        v = self.v_proj(hidden_states)

        q = paddle.reshape(q, [b, s, self.num_heads, self.head_dim])
        k = paddle.reshape(k, [b, s, self.num_kv_heads, self.head_dim])
        v = paddle.reshape(v, [b, s, self.num_kv_heads, self.head_dim])

        offset = 0
        if past_key_value is not None:
            offset = past_key_value[0].shape[1]
        cos_t, sin_t = self.rotary_emb(offset + s, q.place)  # cached tables

        def rope_fn(qd, kd, cos, sin):
            return lf.apply_rope(qd, kd, cos[offset:], sin[offset:])

        q, k = apply(rope_fn, q, k, cos_t, sin_t, _name="fused_rope")

        if past_key_value is not None:
            k = paddle.concat([past_key_value[0], k], axis=1)
            v = paddle.concat([past_key_value[1], v], axis=1)
        new_cache = (k, v) if use_cache else None

        # causal always holds; with a KV cache the offset diagonal
        # tril(k=sk-sq) lets the query chunk at positions [offset, offset+s)
        # see all cached keys while staying causal within the chunk
        if self.config.use_flash_attention and attention_mask is None:
            out = F.flash_attention(q, k, v, causal=True)[0]
        else:
            out = F.scaled_dot_product_attention(
                q, k, v, attn_mask=attention_mask, is_causal=True)
        out = paddle.reshape(out, [b, s, self.num_heads * self.head_dim])
        out = self.o_proj(out)
        if use_cache:
            return out, new_cache
        return out


class LlamaMLP(pnn.Layer):
    """SwiGLU MLP: down(silu(gate(x)) * up(x))."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = pnn.Linear(h, i, bias_attr=False)
        self.up_proj = pnn.Linear(h, i, bias_attr=False)
        self.down_proj = pnn.Linear(i, h, bias_attr=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(pnn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps)
        self.post_attention_layernorm = LlamaRMSNorm(config.hidden_size,
                                                     config.rms_norm_eps)
        self.config = config

    def forward(self, hidden_states, attention_mask=None, position_ids=None,
                past_key_value=None, use_cache=False):
        def block(h):
            residual = h
            h = self.input_layernorm(h)
            cache = None
            if use_cache:
                h, cache = self.self_attn(h, attention_mask, position_ids,
                                          past_key_value, use_cache=True)
            else:
                h = self.self_attn(h, attention_mask, position_ids)
            h = residual + h
            residual = h
            h = self.post_attention_layernorm(h)
            h = residual + self.mlp(h)
            return (h, cache) if use_cache else h

        if self.config.recompute and not use_cache:
            from paddle_tpu_torch.distributed.fleet.recompute import recompute

            return recompute(block, hidden_states)
        return block(hidden_states)


class LlamaModel(pnn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = pnn.Embedding(config.vocab_size, config.hidden_size)
        self.layers = pnn.LayerList(
            [LlamaDecoderLayer(config) for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config.hidden_size, config.rms_norm_eps)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                past_key_values=None, use_cache=False):
        h = self.embed_tokens(input_ids)
        caches = [] if use_cache else None
        for i, layer in enumerate(self.layers):
            pkv = past_key_values[i] if past_key_values is not None else None
            if use_cache:
                h, cache = layer(h, attention_mask, position_ids, pkv, use_cache=True)
                caches.append(cache)
            else:
                h = layer(h, attention_mask, position_ids)
        h = self.norm(h)
        if use_cache:
            return h, caches
        return h


class LlamaPretrainingCriterion(pnn.Layer):
    """Shifted next-token cross entropy: mean CE of logits [b, s, vocab]
    against labels [b, s]."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config

    def forward(self, logits, labels):
        return F.cross_entropy(
            paddle.reshape(logits, [-1, logits.shape[-1]]),
            paddle.reshape(labels, [-1]),
            reduction="mean")


class LlamaForCausalLM(pnn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.llama = self.model = LlamaModel(config)
        self.lm_head = pnn.Linear(config.hidden_size, config.vocab_size,
                                  bias_attr=False)

    def forward(self, input_ids, labels=None, attention_mask=None,
                position_ids=None, past_key_values=None, use_cache=False):
        if use_cache:
            h, caches = self.model(input_ids, attention_mask, position_ids,
                                   past_key_values, use_cache=True)
            return self.lm_head(h), caches
        h = self.model(input_ids, attention_mask, position_ids)
        logits = self.lm_head(h)
        if labels is not None:
            return LlamaPretrainingCriterion(self.config)(logits, labels)
        return logits

    @paddle.no_grad()
    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 compiled=False, top_p=1.0, seed=0):
        """Greedy/temperature decode with KV cache.

        compiled=True stacks the weights into the functional tree
        (`generation.params_from_layer`) and runs the port's
        `generation.generate` over a fixed-size cache (the serving path,
        kernels B4/B5 on the card); the default eager loop re-dispatches
        per step over these layers. Greedy outputs are identical between
        the two."""
        if compiled:
            ids = input_ids.numpy() if hasattr(input_ids, "numpy") \
                else input_ids
            params = generation.params_from_layer(self)
            model = Llama(LlamaArgs.from_config(self.config), params)
            dev = model.device
            out = generation.generate(
                model, ids, max_new_tokens=max_new_tokens,
                temperature=temperature, top_p=top_p,
                generator=torch.Generator(device=dev).manual_seed(seed),
                device=dev)
            return paddle.to_tensor(out, place=dev)
        if seed:
            import warnings

            warnings.warn("generate(seed=...) is only honored on the "
                          "compiled path; the eager loop draws from the "
                          "global generator (use paddle.seed)")
        tokens = input_ids
        past = None
        cur = tokens
        for _ in range(max_new_tokens):
            logits, past = self.forward(cur, past_key_values=past, use_cache=True)
            next_logits = logits[:, -1, :]
            if temperature and temperature > 0:
                next_logits = next_logits / temperature
                if top_p < 1.0:
                    # nucleus mask, same rule as the compiled sampler
                    sorted_l = paddle.sort(next_logits, axis=-1,
                                           descending=True)
                    probs_s = F.softmax(sorted_l, axis=-1)
                    cum = paddle.cumsum(probs_s, axis=-1)
                    k = paddle.sum(paddle.cast(cum < top_p, "int32"),
                                   axis=-1, keepdim=True)
                    cutoff = paddle.take_along_axis(sorted_l, k, axis=-1)
                    next_logits = paddle.where(
                        next_logits >= cutoff, next_logits,
                        paddle.full_like(next_logits, -1e30))
                probs = F.softmax(next_logits, axis=-1)
                nxt = paddle.multinomial(probs, 1)
            else:
                nxt = paddle.argmax(next_logits, axis=-1, keepdim=True)
            nxt = paddle.cast(nxt, tokens.dtype)
            tokens = paddle.concat([tokens, nxt], axis=1)
            cur = nxt
        return tokens
