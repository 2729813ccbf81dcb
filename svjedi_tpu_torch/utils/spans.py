"""Host spans of the align stage on two clocks.

``with span(timings, key, name):`` adds the block's ``perf_counter``
seconds to ``timings[key]`` (where ``timings`` is a dict and ``key`` is not
None) and, only while a ``torch.profiler`` records on the calling thread,
opens ``record_function(name)``, so the block also shows in the profiler's
trace on the clock of the device's kernels and copies. With no profiler and
``timings=None`` it does nothing beyond one branch.

The profiler's state is per thread: a block on a thread the profiler was
not started on (the seeder thread of ``align_and_count``) counts into
``timings`` but leaves no range in the trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

_NOTHING = contextlib.nullcontext()


class _Span:
    __slots__ = ("timings", "key", "rf", "t0")

    def __init__(self, timings, key, rf):
        self.timings, self.key, self.rf = timings, key, rf

    def __enter__(self):
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.timings is not None and self.key is not None:
            self.timings[self.key] = self.timings.get(self.key, 0.0) + dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(timings: Optional[Dict], key: Optional[str], name: str):
    """A context manager timing its block into ``timings[key]`` and, under
    a recording profiler, naming it ``name`` in the trace."""
    rf = (torch.profiler.record_function(name)
          if torch.autograd._profiler_enabled() else None)
    if rf is None and timings is None:
        return _NOTHING
    return _Span(timings, key, rf)


def add(timings: Optional[Dict], key: str, n) -> None:
    """Add the work count ``n`` to ``timings[key]`` (where ``timings`` is a
    dict)."""
    if timings is not None:
        timings[key] = timings.get(key, 0) + int(n)
