"""Structured timing/metrics beside the reference's single ``Runtime(sec):``
stderr line (ntcard.cpp:321,476); the port's copy of
ntcard_tpu/utils/metrics.py without its profiler hook.

Phases: pipeline (decode, pack and device update), finalize, estimate,
output. Enabled with ``--metrics`` (ntcard CLI) or ``NTCARD_METRICS=1``;
emits one JSON object to stderr.
"""

from __future__ import annotations

import json
import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, Optional


class Metrics:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled or bool(os.environ.get("NTCARD_METRICS"))
        self.phases: Dict[str, float] = {}
        self.counters: Dict[str, float] = {}
        self._t0 = time.monotonic()

    @contextmanager
    def phase(self, name: str):
        t = time.monotonic()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (time.monotonic() - t)

    def add(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def tag(self, name: str, value: str) -> None:
        """Non-numeric annotation (e.g. which engine ran)."""
        self.tags = getattr(self, "tags", {})
        self.tags[name] = value

    def report(self, stream=None) -> Optional[dict]:
        if not self.enabled:
            return None
        total = time.monotonic() - self._t0
        out = {
            "total_sec": round(total, 4),
            "phases_sec": {k: round(v, 4) for k, v in self.phases.items()},
            "counters": {k: round(v, 1) for k, v in self.counters.items()},
        }
        out.update(getattr(self, "tags", {}))
        bases = self.counters.get("bases", 0)
        reads = self.counters.get("reads", 0)
        if bases and total > 0:
            out["gbp_per_sec"] = round(bases / total / 1e9, 4)
        if reads and total > 0:
            out["reads_per_sec"] = round(reads / total, 1)
        (stream or sys.stderr).write(json.dumps(out) + "\n")
        return out
