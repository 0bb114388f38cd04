"""Continuous-batching LLM serving (port of `paddle_tpu.serving`).

  - `Engine` (serving/engine.py): slot-based KV cache, one `max_len`
    stripe per slot;
  - `PagedEngine` (serving/paged_engine.py): one page pool + per-slot block
    tables (`serving/block_manager.py`: refcounted pages, copy-on-write,
    leaf-LRU eviction) with radix-tree prefix reuse.

Both share the iteration-level scheduler (`serving/scheduler.py`), the
per-request sampler (`serving/sampler.py`) and the metrics
(`serving/metrics.py`); `serving/trace.py` makes seeded arrival traces.
`PagedEngine(kv_dtype="int8")` keeps an int8 page pool, and both engines
serve weight-only int8 models (`models.quantize_params`).

`serving/disagg.py` splits prefill from decode (`PrefillWorker` and
`DecodeWorker` exchange KV pages as `KVHandoff` blobs over
`LocalTransport`, or `StoreTransport` on a TCPStore; `DisaggServer` wires
a pair in one process). `serving/router.py` fronts several models with
one SLO-aware `Router`: Llama on `PagedEngine`, GPT-2 on `GptEngine`,
BERT embeddings on `BertBackend`; batch work is preempted for
interactive work.

    from paddle_tpu_torch.models import LLAMA2_7B, Llama, init_params
    from paddle_tpu_torch.serving import PagedEngine, Request

    model = Llama(LLAMA2_7B, init_params(LLAMA2_7B, dtype=torch.bfloat16))
    eng = PagedEngine(model, max_slots=8, max_len=2048, page_size=16)
    req = eng.submit(Request(prompt_ids, max_new_tokens=64))
    eng.run_until_idle()          # req.token_ids, req.ttft_s, ...
"""

from paddle_tpu_torch.serving.block_manager import (NULL_PAGE, BlockAllocator,
                                                    PrefixMatch)
from paddle_tpu_torch.serving.disagg import (DecodeWorker, DisaggServer,
                                             KVHandoff, LocalTransport,
                                             PrefillWorker, StoreTransport)
from paddle_tpu_torch.serving.engine import Engine, Request
from paddle_tpu_torch.serving.metrics import Metrics
from paddle_tpu_torch.serving.paged_engine import PagedEngine
from paddle_tpu_torch.serving.router import (SLO_CLASSES, BertBackend,
                                             EmbeddingRequest, GptEngine,
                                             Router)
from paddle_tpu_torch.serving.sampler import SlotSampler, pick
from paddle_tpu_torch.serving.scheduler import (AdmissionQueue, SlotTable,
                                                bucket_for, pages_for)
from paddle_tpu_torch.serving.trace import (make_mixed_trace, make_trace,
                                            trace_stats)

__all__ = ["Engine", "PagedEngine", "Request", "Metrics", "BlockAllocator",
           "PrefixMatch", "NULL_PAGE", "AdmissionQueue", "SlotTable",
           "SlotSampler", "pick", "bucket_for", "pages_for", "make_trace",
           "make_mixed_trace", "trace_stats", "KVHandoff", "LocalTransport",
           "StoreTransport", "PrefillWorker", "DecodeWorker", "DisaggServer",
           "SLO_CLASSES", "GptEngine", "EmbeddingRequest", "BertBackend",
           "Router"]
