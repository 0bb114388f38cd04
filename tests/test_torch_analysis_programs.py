"""The port's program families (`paddle_tpu_torch/analysis/programs.py`)
held against the JAX package's at TOY (`paddle_tpu/analysis/programs.py`):

  - the serving and disagg captures name the same programs as JAX's
    `serving_programs(tp=0)` and `disagg_programs()`;
  - each program's collective census fingerprints as JAX's;
  - the fused CE has no (b, s, vocab) value on either side, and the
    unchunked reference has one on both;
  - the port's goldens and byte ceilings are the JAX package's, and every
    port program fits them;
  - `run_cpu_audits()` of the port is empty, a family that is not
    captured is reported, not silent, and `python -m
    paddle_tpu_torch.analysis` exits 0 clean and 1 on a seeded family.

The JAX builders are memoized per process: each side is built once here.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from paddle_tpu.analysis import buffer_audit as ref_buffer
from paddle_tpu.analysis import collective_audit as ref_collective
from paddle_tpu.analysis import presets as ref_presets
from paddle_tpu.analysis import programs as ref_programs
from paddle_tpu_torch.analysis import (buffer_audit, collective_audit,
                                       presets, programs)
from paddle_tpu_torch.analysis import __main__ as cli

# one intra-op thread a process: six xdist workers each running torch's
# default pool of a thread a core oversubscribe the machine, and every
# file of the run, the JAX package's too, then runs many times slower
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _fp(census):
    return ref_collective.fingerprint(census)


@pytest.mark.parametrize("family", ["serving", "disagg"])
def test_captured_programs_and_fingerprints_match_the_jax_package(family):
    """The same program names; each census fingerprints as JAX's (empty on
    one card: the TP psums need a mesh)."""
    if family == "serving":
        ref, port = ref_programs.serving_programs(tp=0), \
            programs.serving_programs(device="cpu")
    else:
        ref, port = ref_programs.disagg_programs(), programs.disagg_programs(device="cpu")
    assert sorted(port) == sorted(ref)
    for name in ref:
        got = collective_audit.fingerprint(
            collective_audit.collective_census(port[name]))
        want = _fp(ref_collective.collective_census(ref[name].jaxpr))
        assert got == want, name


def test_fused_ce_forbidden_shape_verdicts_match():
    """No (b, s, vocab) value in the fused CE on either side; the unchunked
    reference holds one on both (the teeth)."""
    ref_fused, ref_ref = ref_programs.fused_ce_programs()
    fused, unchunked = programs.fused_ce_programs("cpu")
    bsv = (programs.TOY_BATCH, programs.TOY_SEQ, programs.TOY["vocab_size"])
    assert fused.meta["forbidden_shape"] == ref_fused.meta[
        "forbidden_shape"] == bsv
    assert not buffer_audit.has_shape(fused, bsv)
    assert not ref_buffer.has_shape(ref_fused.jaxpr, bsv)
    assert buffer_audit.has_shape(unchunked, bsv)
    assert ref_buffer.has_shape(ref_ref.jaxpr, bsv)
    v = buffer_audit.check_forbidden_shape(unchunked, bsv, unchunked.name)
    assert any(x.provenance.startswith("llama_functional.py:")
               and x.provenance.endswith("(parallel_cross_entropy)")
               for x in v), v


def test_goldens_and_ceilings_are_the_jax_packages():
    """The port pins the JAX package's collective goldens and byte
    ceilings; the one-card serving family holds the empty census."""
    assert presets.GOLDEN_COLLECTIVES == ref_presets.GOLDEN_COLLECTIVES
    assert presets.GOLDEN_DISAGG == ref_presets.GOLDEN_DISAGG
    assert presets.BYTE_CEILINGS == ref_presets.BYTE_CEILINGS
    assert set(presets.GOLDEN_ONE_CARD.values()) == {(0, "da39a3ee5e6b")}
    progs = {**programs.serving_programs(device="cpu"),
             **programs.disagg_programs(device="cpu")}
    progs["hybrid_train_step"] = programs.train_step_program(device="cpu")
    progs["fused_opt_writeback"] = programs.opt_writeback_program(
        device="cpu")
    progs["fused_ce_fwd_bwd"] = programs.fused_ce_programs("cpu")[0]
    assert set(progs) == set(presets.BYTE_CEILINGS)
    for name, p in progs.items():
        top = buffer_audit.intermediates(p)
        assert not top or top[0][0] <= presets.BYTE_CEILINGS[name], name


def test_train_step_holds_the_backward_operators_and_writes_state():
    """The audited train step is the engine's: one rms_norm and one
    rms_norm_bwd node a norm (2L + 1), the fused CE's chunks, no (b, s,
    vocab) value; params, m, v and the master weights written in place."""
    p = programs.train_step_program(device="cpu")
    counts = p.node_counts()
    assert counts["paddle_tpu_torch.rms_norm.default"] == 5
    assert counts["paddle_tpu_torch.rms_norm_bwd.default"] == 5
    assert presets.audit_train(p) == []
    names = {path.split("]")[0] for a, path in p.leaves if a == 1}
    assert names == {"['m'", "['v'", "['master'"}


def test_serving_programs_hold_the_decode_operators():
    """The paged decode steps hold one B6 (bf16 pool) or B7 (int8 pool)
    node a layer; the GPT stripe programs B4 (decode) and B5 (prefill)."""
    s = programs.serving_programs(device="cpu")
    d = programs.disagg_programs(device="cpu")
    two = programs.TOY["num_layers"]
    for name, op in (("paged_decode", "paged_decode_attention"),
                     ("paged_decode_int8", "paged_decode_attention_q8")):
        assert s[name].node_counts()[f"paddle_tpu_torch.{op}.default"] == two
    assert d["gpt_decode"].node_counts()[
        "paddle_tpu_torch.decode_attention.default"] == two
    assert d["gpt_prefill"].node_counts()[
        "paddle_tpu_torch.window_attention.default"] == two


def test_tp_serving_raises_naming_a9():
    with pytest.raises(NotImplementedError, match="A9"):
        programs.serving_programs(tp=2, device="cpu")


def test_run_cpu_audits_all_families_clean():
    assert presets.run_cpu_audits(device="cpu") == []


@pytest.mark.parametrize("family, dropped", [("serving", "spec_verify"),
                                             ("disagg", "page_scatter")])
def test_missing_program_is_reported_not_silent(family, dropped,
                                                monkeypatch):
    builder = f"{family}_programs"
    real = getattr(programs, builder)(device="cpu")
    pruned = {k: v for k, v in real.items() if k != dropped}
    monkeypatch.setattr(programs, builder, lambda **kw: pruned)
    v = getattr(presets, f"audit_{family}")(device="cpu")
    assert any(x.rule == "audit.program-not-captured"
               and x.program == dropped for x in v)


def test_cli_exits_0_clean_and_1_on_a_seeded_family(monkeypatch, capsys):
    """In a fresh interpreter the CLI prints the clean line and exits 0;
    with the unchunked reference standing in for the fused CE it prints
    the violation with its provenance and exits 1."""
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.analysis", "--families",
         "opt_writeback", "--device", "cpu"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "program audit: clean (opt_writeback; cpu)" in \
        res.stdout
    fused, unchunked = programs.fused_ce_programs("cpu")
    monkeypatch.setattr(programs, "fused_ce_programs",
                        lambda device=None: (unchunked, unchunked))
    assert cli.main(["--families", "fused_ce", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "[buffer.forbidden-shape] unchunked_ce_reference" in out
    assert "@ llama_functional.py:" in out
    assert "violation(s)" in out.splitlines()[-1]
