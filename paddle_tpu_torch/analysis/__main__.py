"""The program audit as a command (the port's counterpart of the
reference's `tools/lint.py --audit-only`):

    python -m paddle_tpu_torch.analysis                 # every family,
                                                        # on the card
    python -m paddle_tpu_torch.analysis --device cpu    # on the CPU
    python -m paddle_tpu_torch.analysis --families serving train_step
    python -m paddle_tpu_torch.analysis --report        # + each program's
                                                        # largest buffer

Exit code 0 = every invariant holds; 1 = violations (each printed with
provenance). The families are traced at toy size over fake tensors; the
engines that capture the serving programs serve a few tiny requests on
`--device`, the card unless it says cpu (with no card that raises).
"""

from __future__ import annotations

import argparse
import sys

from paddle_tpu_torch.analysis import buffer_audit, presets, programs
from paddle_tpu_torch.device import resolve_device


def report(device=None):
    """Print each toy program's largest intermediate beside its ceiling."""
    progs = {**programs.serving_programs(tp=0, device=device),
             **programs.disagg_programs(device=device)}
    progs["fused_ce_fwd_bwd"] = programs.fused_ce_programs(device)[0]
    progs["hybrid_train_step"] = programs.train_step_program(device=device)
    progs["fused_opt_writeback"] = programs.opt_writeback_program(
        device=device)
    for name, p in sorted(progs.items()):
        top = buffer_audit.top_intermediates(p, k=1)
        row = top[0] if top else {"nbytes": 0, "shape": (), "dtype": "-",
                                  "provenance": "no buffer"}
        ceilings = (presets.BYTE_CEILINGS_CARD if p.meta.get("toy") ==
                    "card" else presets.BYTE_CEILINGS)
        print(f"{name}: largest intermediate {row['nbytes']} bytes "
              f"{row['shape']} {row['dtype']} @ {row['provenance']}; "
              f"ceiling {ceilings.get(name)} ({p.meta.get('toy')} toy)")


def run_program_audit(families=presets.FAMILIES, device=None):
    violations = presets.run_cpu_audits(families=families, device=device)
    for v in violations:
        print(v)
    if violations:
        print(f"program audit: {len(violations)} violation(s)")
        return 1
    print(f"program audit: clean ({', '.join(families)}; "
          f"{resolve_device(device).type})")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", nargs="+", default=list(presets.FAMILIES),
                    choices=presets.FAMILIES,
                    help="program-audit families to run")
    ap.add_argument("--device", choices=("cpu", "cuda"),
                    help="where the engines run and the programs trace "
                         "(default: the card)")
    ap.add_argument("--report", action="store_true",
                    help="also print each program's largest intermediate")
    ns = ap.parse_args(argv)
    if ns.report:
        report(ns.device)
    return run_program_audit(tuple(ns.families), ns.device)


if __name__ == "__main__":
    sys.exit(main())
