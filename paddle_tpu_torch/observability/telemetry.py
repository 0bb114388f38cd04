"""Structured per-run telemetry artifacts (a copy of
`paddle_tpu/observability/telemetry.py`, the same schema string).

`write_run_telemetry` leaves one diffable JSON record of a run: a
caller's record payload plus a full registry snapshot (step-time
histograms, MFU, the tuner's picks, checkpoint counters).
"""

from __future__ import annotations

import json
import os
import time

__all__ = ["SCHEMA", "write_run_telemetry"]

SCHEMA = "paddle_tpu.telemetry/v1"


def write_run_telemetry(path, *, record=None, registry=None, meta=None):
    """Atomically write one run's telemetry JSON; returns the payload."""
    payload = {"schema": SCHEMA, "unix_time": time.time(), "meta": meta or {}}
    if record is not None:
        payload["record"] = record
    if registry is not None:
        payload["metrics"] = registry.snapshot()
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=str)
        f.write("\n")
    os.replace(tmp, path)
    return payload
