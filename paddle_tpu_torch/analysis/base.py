"""Shared audit types: the Violation record every rule emits."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Violation:
    """One broken invariant, with enough context to act on it.

    rule:       dotted rule id, e.g. "buffer.forbidden-shape".
    program:    the audited program's name (or the linted file).
    message:    what broke, in one sentence, with the offending numbers.
    provenance: best-effort "file.py:line (function)" of the offending
                graph node: the first frame outside torch that recorded
                it (`graph_walk.provenance`).
    """

    rule: str
    program: str
    message: str
    provenance: str = ""

    def __str__(self):
        loc = f"  @ {self.provenance}" if self.provenance else ""
        return f"[{self.rule}] {self.program}: {self.message}{loc}"


def format_violations(violations):
    """Render a violation list as the block CI prints on failure."""
    if not violations:
        return "no violations"
    return "\n".join(str(v) for v in violations)
