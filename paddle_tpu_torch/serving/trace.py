"""Deterministic arrival traces for the serving engines (port of
`tools/serving_trace.py`: `make_trace` :25, `make_mixed_trace` :109 and
`trace_stats` :152, numpy only).

Arrivals are exponential gaps measured in ENGINE STEPS, not seconds: the
trace is pure data, replayed by `Engine.replay`, which advances one
scheduler iteration at a time. The same seed gives the reference's trace,
token for token.

    from paddle_tpu_torch.serving.trace import make_trace
    reqs = engine.replay(make_trace(seed=0, n_requests=24))
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_trace", "make_mixed_trace", "trace_stats"]


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


def make_mixed_trace(seed=0, n_short=24, short_len_choices=(3, 5, 7, 9, 12),
                     n_long=2, long_len=192, burst_step=None,
                     mean_interarrival_steps=2.0, new_tokens_choices=(8,),
                     long_new_tokens=8, vocab_size=128, pad_id=0):
    """A long-prompt burst dropped into a short-prompt stream, the trace of
    chunked prefill: the shorts arrive as `make_trace`'s stream; `n_long`
    long prompts all arrive at `burst_step` (default: mid-stream) and land
    first in the queue, so the shorts right behind them measure how long a
    monolithic long prefill stalls the scheduler. Entries carry a 'long'
    flag."""
    shorts = make_trace(seed=seed, n_requests=n_short,
                        mean_interarrival_steps=mean_interarrival_steps,
                        prompt_len_choices=tuple(short_len_choices),
                        new_tokens_choices=tuple(new_tokens_choices),
                        vocab_size=vocab_size, pad_id=pad_id)
    for t in shorts:
        t["long"] = False
    if burst_step is None:
        arr = sorted(t["arrival_step"] for t in shorts)
        burst_step = arr[len(arr) // 2]
    rng = np.random.default_rng(seed + 101)
    longs = []
    for i in range(n_long):
        prompt = rng.integers(1, vocab_size, size=int(long_len)).astype(
            np.int32)
        if pad_id != 0:
            prompt[prompt == pad_id] = (pad_id + 1) % vocab_size or 1
        longs.append({"request_id": n_short + i,
                      "arrival_step": int(burst_step), "prompt": prompt,
                      "max_new_tokens": int(long_new_tokens),
                      "shared_prefix": False, "long": True})
    return sorted(shorts + longs,
                  key=lambda t: (t["arrival_step"], not t["long"]))


def trace_stats(trace):
    """Lengths, token counts and arrival span of a trace."""
    plens = [len(t["prompt"]) for t in trace]
    return {
        "n_requests": len(trace),
        "total_new_tokens": sum(t["max_new_tokens"] for t in trace),
        "prompt_len_min": min(plens),
        "prompt_len_max": max(plens),
        "distinct_prompt_lens": len(set(plens)),
        "last_arrival_step": max(t["arrival_step"] for t in trace),
        "shared_prefix_requests": sum(1 for t in trace
                                      if t.get("shared_prefix")),
        "long_requests": sum(1 for t in trace if t.get("long")),
    }
