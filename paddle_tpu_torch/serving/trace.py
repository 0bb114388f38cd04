"""Deterministic arrival traces for the serving engines (port of
`tools/serving_trace.py::make_trace`, numpy only).

Arrivals are exponential gaps measured in ENGINE STEPS, not seconds: the
trace is pure data, replayed by `Engine.replay`, which advances one
scheduler iteration at a time. The same seed gives the reference's trace,
token for token.

    from paddle_tpu_torch.serving.trace import make_trace
    reqs = engine.replay(make_trace(seed=0, n_requests=24))
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_trace"]


def make_trace(seed=0, n_requests=24, mean_interarrival_steps=2.0,
               prompt_len_choices=(3, 5, 7, 9, 12, 17, 23, 31),
               new_tokens_choices=(4, 8, 12), vocab_size=128, pad_id=0,
               eos_token_id=None, shared_prefix_len=0,
               shared_prefix_ratio=1.0):
    """Mixed-length request trace: each entry is {'request_id',
    'arrival_step', 'prompt' (int32 [len], never pad_id), 'max_new_tokens',
    'shared_prefix'[, 'eos_token_id']}, the dict `Engine.replay` takes.

    shared_prefix_len > 0 prepends one seeded prefix of that length to a
    `shared_prefix_ratio` fraction of the requests (prompt_len_choices
    then size the unique suffix): system-prompt reuse."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_interarrival_steps, n_requests)
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    prefix = None
    if shared_prefix_len:
        prefix = rng.integers(1, vocab_size,
                              size=int(shared_prefix_len)).astype(np.int32)
    trace = []
    for i in range(n_requests):
        plen = int(rng.choice(prompt_len_choices))
        prompt = rng.integers(1, vocab_size, size=plen).astype(np.int32)
        shared = (prefix is not None
                  and float(rng.random()) < shared_prefix_ratio)
        if shared:
            prompt = np.concatenate([prefix, prompt])
        if pad_id != 0:
            prompt[prompt == pad_id] = (pad_id + 1) % vocab_size or 1
        entry = {"request_id": i, "arrival_step": int(arrivals[i]),
                 "prompt": prompt,
                 "max_new_tokens": int(rng.choice(new_tokens_choices)),
                 "shared_prefix": shared}
        if eos_token_id is not None:
            entry["eos_token_id"] = int(eos_token_id)
        trace.append(entry)
    return trace
