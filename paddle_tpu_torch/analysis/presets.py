"""The wired-up audit: every rule over every real program family (port of
`paddle_tpu/analysis/presets.py`).

`run_cpu_audits()` is the single entry point the tests and `python -m
paddle_tpu_torch.analysis` share. It builds the five program families at
toy size (fused-CE fwd+bwd, the hybrid engine's train step, the
optimizer write-back, the PagedEngine's captured serving steps, and the
disaggregated-serving migration + router-GPT programs) and applies the
rule suite with the repo's pinned invariants:

  - no [batch, seq, vocab] intermediate anywhere near the loss;
  - per-program byte ceilings on the largest intermediate (backstop for
    shape regressions the forbidden-shape probe doesn't name);
  - donated state (params, optimizer state, KV page pool) written in
    place;
  - bf16 AMP: f32 matrix products only at allowlisted loss/norm sites;
  - no host reads or copies to the host in any step program;
  - collectives pinned by count AND fingerprint. On one card the serving
    family holds none (`GOLDEN_ONE_CARD`); the TP goldens
    (`GOLDEN_COLLECTIVES`: every row-parallel matmul carries exactly one
    all-reduce, 2 per layer body) are the reference's and stay as data
    for the tensor-parallel engine (ROADMAP A9).

GOLDEN fingerprints are regenerated with
`collective_audit.fingerprint(collective_audit.collective_census(g))`
after an INTENTIONAL collective change — say why in the diff.
"""

from __future__ import annotations

from paddle_tpu_torch.analysis import (buffer_audit, collective_audit,
                                       donation_audit, dtype_audit,
                                       host_sync_audit, programs)
from paddle_tpu_torch.analysis.base import Violation

__all__ = ["GOLDEN_COLLECTIVES", "GOLDEN_ONE_CARD", "GOLDEN_DISAGG",
           "BYTE_CEILINGS", "BYTE_CEILINGS_CARD", "FAMILIES",
           "run_cpu_audits", "audit_fused_ce",
           "audit_train", "audit_train_step", "audit_opt_writeback",
           "audit_program", "audit_programs", "audit_serving",
           "audit_disagg"]

# static collective structure of each TP serving program (the reference's
# goldens, tp=2): 2 row-parallel psum epilogues (wo, w_down) per layer
# body; page_copy is pure data movement and must stay collective-free
_TP_FP = "a91763b43edf"       # psum@mp;psum@mp
_EMPTY_FP = "da39a3ee5e6b"    # empty census
GOLDEN_COLLECTIVES = {
    "paged_prefill": (2, _TP_FP),
    "paged_decode": (2, _TP_FP),
    "spec_verify": (2, _TP_FP),
    "page_copy": (0, _EMPTY_FP),
    # kv_dtype='int8': quantize-at-scatter / dequant-at-gather are
    # elementwise per shard, so the census must be IDENTICAL to the
    # model-dtype pool
    "paged_prefill_int8": (2, _TP_FP),
    "paged_decode_int8": (2, _TP_FP),
    "page_copy_int8": (0, _EMPTY_FP),
}
# the same programs on one card: no collective at all
GOLDEN_ONE_CARD = {name: (0, _EMPTY_FP) for name in GOLDEN_COLLECTIVES}

# the disaggregated-serving + router family is its OWN golden dict: the
# migration pair is pure data movement — a collective creeping into
# extract/scatter would put a cross-shard hop on every hand-off; the GPT
# stripe programs are single-card.
GOLDEN_DISAGG = {
    "page_extract": (0, _EMPTY_FP),
    "page_scatter": (0, _EMPTY_FP),
    "page_extract_int8": (0, _EMPTY_FP),
    "page_scatter_int8": (0, _EMPTY_FP),
    "gpt_prefill": (0, _EMPTY_FP),
    "gpt_decode": (0, _EMPTY_FP),
}

# largest-intermediate ceilings at the toy geometry (measured max plus
# ~40% headroom, the reference's method): a blowup past these means a
# buffer class that did not exist when the budget was pinned. Where the
# port's program differs from the reference's, the entry says why.
BYTE_CEILINGS = {
    "fused_ce_fwd_bwd": 12 * 1024,
    "hybrid_train_step": 18 * 1024,
    "fused_opt_writeback": 18 * 1024,
    "paged_prefill": 26 * 1024,
    "paged_decode": 26 * 1024,
    "spec_verify": 26 * 1024,
    "page_copy": 26 * 1024,
    "paged_prefill_int8": 26 * 1024,
    "paged_decode_int8": 26 * 1024,
    "page_copy_int8": 26 * 1024,
    "page_extract": 6 * 1024,
    "page_extract_int8": 2 * 1024,
    "page_scatter": 26 * 1024,
    "page_scatter_int8": 7 * 1024,
    "gpt_prefill": 23 * 1024,
    "gpt_decode": 23 * 1024,
}

# the same at TOY_CARD, the toy's geometry on a card (head_dim 64): the
# largest intermediate `python -m paddle_tpu_torch.analysis --device cuda
# --report` measures on the card, plus ~40% headroom, rounded up to a KiB;
# 1 KiB where the program allocates no buffer (a page copy writes through
# views)
BYTE_CEILINGS_CARD = {
    "fused_ce_fwd_bwd": 45 * 1024,        # d_head [128, 64] f32, 32 KiB
    "hybrid_train_step": 180 * 1024,      # an f32 [2, 128, 128] leaf, 128
    "fused_opt_writeback": 180 * 1024,    # the same
    "paged_prefill": 68 * 1024,           # the scratch stripe, 48 KiB
    "paged_prefill_int8": 68 * 1024,
    "paged_decode": 2 * 1024,             # 1 KiB
    "paged_decode_int8": 12 * 1024,       # the re-scaled page, 8 KiB
    "spec_verify": 45 * 1024,             # the gathered table, 32 KiB
    "page_copy": 1024,
    "page_copy_int8": 1024,
    "page_extract": 23 * 1024,            # the request's pages, 16 KiB
    "page_extract_int8": 6 * 1024,        # 4 KiB
    # the shipped pages arrive on the host: the scatter's copy onto the
    # card is its one buffer (16 KiB, 4 KiB; none on the CPU)
    "page_scatter": 23 * 1024,
    "page_scatter_int8": 6 * 1024,
    "gpt_prefill": 12 * 1024,             # 8 KiB
    "gpt_decode": 2 * 1024,               # 1 KiB
}

FAMILIES = ("fused_ce", "train_step", "opt_writeback", "serving", "disagg")


def _common(p, out):
    """Rules every program family gets: host-sync ban + byte ceiling (at
    the geometry the program was traced at)."""
    out += host_sync_audit.check_host_sync(p, p.name)
    ceilings = (BYTE_CEILINGS_CARD if p.meta.get("toy") == "card"
                else BYTE_CEILINGS)
    ceiling = ceilings.get(p.name)
    if ceiling is not None and p.graph_module is not None:
        out += buffer_audit.check_byte_ceiling(p, ceiling, p.name)


def _missing(golden, progs, what):
    # a family that silently stopped being captured is itself a finding —
    # the audit must not go blind without failing
    return [Violation(
        rule="audit.program-not-captured", program=name,
        message=f"{what} program was never dispatched/captured — "
                "scheduler or capture-harness change?")
        for name in sorted(set(golden) - set(progs))]


def audit_fused_ce(device=None):
    fused, _ = programs.fused_ce_programs(device)
    out = buffer_audit.check_forbidden_shape(
        fused, fused.meta["forbidden_shape"], fused.name, "full-logits")
    _common(fused, out)
    return out


def audit_train(p):
    """The train-step rules over one traced step (`train_step_trace`)."""
    out = []
    if p.graph_module is not None:
        out += buffer_audit.check_forbidden_shape(
            p, p.meta["forbidden_shape"], p.name, "full-logits")
        out += dtype_audit.check_dtype_policy(p, p.name,
                                              policy=p.meta["policy"])
        out += collective_audit.check_collectives(
            p, p.name, expect_count=0, expect_fingerprint=_EMPTY_FP)
    out += donation_audit.check_donation(p)
    _common(p, out)
    return out


def audit_train_step(device=None):
    return audit_train(programs.train_step_program(device=device))


def audit_opt_writeback(device=None):
    p = programs.opt_writeback_program(device=device)
    out = donation_audit.check_donation(p)
    _common(p, out)
    return out


def audit_program(p, count=0, fp=_EMPTY_FP):
    """Census (held to `count` and `fp`), donation, host-sync and ceiling
    rules over one captured program."""
    out = []
    if p.graph_module is not None:
        out += collective_audit.check_collectives(
            p, p.name, expect_count=count, expect_fingerprint=fp)
    out += donation_audit.check_donation(p)
    _common(p, out)
    return out


def audit_programs(progs, golden, what="serving"):
    """`audit_program` over captured programs, each held to its golden; a
    golden name never captured is a finding."""
    out = _missing(golden, progs, what)
    for name, p in sorted(progs.items()):
        out += audit_program(p, *golden.get(name, (None, None)))
    return out


def audit_serving(tp=0, device=None):
    """The PagedEngine's captured programs; tp > 0 raises (ROADMAP A9)."""
    return audit_programs(programs.serving_programs(tp=tp, device=device),
                          GOLDEN_ONE_CARD)


def audit_disagg(device=None):
    """The disaggregated-serving family: KV-page migration programs
    (model-dtype + int8 pools) and the router's GPT stripe programs."""
    return audit_programs(programs.disagg_programs(device=device),
                          GOLDEN_DISAGG, "disagg")


def run_cpu_audits(families=FAMILIES, device=None):
    """Run every audit family on `device`; returns the full list of
    Violations (empty = the port's programs uphold every invariant)."""
    runners = {
        "fused_ce": audit_fused_ce,
        "train_step": audit_train_step,
        "opt_writeback": audit_opt_writeback,
        "serving": audit_serving,
        "disagg": audit_disagg,
    }
    out = []
    for fam in families:
        out += runners[fam](device=device)
    return out
