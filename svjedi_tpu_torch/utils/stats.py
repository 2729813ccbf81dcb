# Copied verbatim from svjedi_tpu/utils/stats.py.
"""Structured per-stage stats and timing (SURVEY §5.1/§5.5 upgrade).

The reference only prints stage banners (svjedi-graph.py:82,92,111,121) and a
"Genotyped svs: N" summary. Here every stage records counters and wall time
into one :class:`RunStats` that is dumped as ``<prefix>_stats.json``.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class RunStats:
    counters: Dict[str, Any] = field(default_factory=dict)
    timings_s: Dict[str, float] = field(default_factory=dict)

    def set(self, key: str, value: Any) -> None:
        self.counters[key] = value

    def add(self, key: str, value: float) -> None:
        self.counters[key] = self.counters.get(key, 0) + value

    @contextmanager
    def timer(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings_s[stage] = self.timings_s.get(stage, 0.0) + (
                time.perf_counter() - t0
            )

    def dump(self, path) -> None:
        with open(path, "w") as fh:
            json.dump(
                {"counters": self.counters, "timings_s": self.timings_s},
                fh,
                indent=2,
                sort_keys=True,
                default=str,
            )
            fh.write("\n")
