"""Static analysis for traced programs (the framework's self-check layer;
port of `paddle_tpu/analysis/`).

The reference framework's equivalents are *invariants on the program
itself* — no [b, s, vocab] buffer in the fused-CE step, optimizer state
donated, exactly one all-reduce per row-parallel matmul — and this
package checks them statically: trace the real program with `make_fx`
over fake tensors, walk its FX graph, and fail loudly (with the node's
provenance) when an invariant breaks. Everything here runs at test time,
on the CPU, in seconds; the same builders trace the 7B-width programs on
the card (`chip_smoke.py --phases analysis`).

Layout:
  graph_walk        reusable FX graph walker (higher-order operator
                    subgraphs, provenance stamped while tracing); also
                    importable as `analysis.jaxpr_walk`, the reference's
                    name
  buffer_audit      largest intermediates, byte ceilings, forbidden shapes
  donation_audit    donated state written in place
  dtype_audit       f32 matrix products under a bf16 policy (allowlisted
                    sites)
  host_sync_audit   host reads and copies to the host in step programs
  collective_audit  collective census + fingerprint per program
  programs          builders that trace the REAL program families at toy
                    size (train step, paged serving steps, fused CE,
                    optimizer write-back, disagg migration, router GPT)
  presets           the default audit suite

`python -m paddle_tpu_torch.analysis [--families ...] [--device cpu|cuda]`
prints each violation with its provenance and exits 1 on any, 0 when
clean.
"""

import sys as _sys

from paddle_tpu_torch.analysis.base import Violation  # noqa: F401
from paddle_tpu_torch.analysis import (  # noqa: F401
    buffer_audit,
    collective_audit,
    donation_audit,
    dtype_audit,
    graph_walk,
    host_sync_audit,
)

# the reference's module name for the walker
jaxpr_walk = graph_walk
_sys.modules[__name__ + ".jaxpr_walk"] = graph_walk

__all__ = [
    "Violation",
    "jaxpr_walk",
    "buffer_audit",
    "donation_audit",
    "dtype_audit",
    "host_sync_audit",
    "collective_audit",
]
