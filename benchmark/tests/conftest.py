"""Shared pieces of the harness's CPU tests (``python -m pytest
benchmark/tests``): a tiny cell run on the CPU with the program's plain
kernels, and the repository root on ``sys.path``."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: A catalogue and sample small enough for the CPU: 120 kb, 12 SVs, 8x of
#: 3 kb reads (~330 reads).
TINY_CONFIG = {"genome_bp": 120_000, "n_svs": 12, "name": "tiny"}
TINY_MIX = {"coverage": 8, "mean_len": 3000, "sd_len": 1000,
            "name": "tinymix"}


@pytest.fixture
def tiny_cell():
    """The first cell of BENCHMARK.json cut to a CPU's size (its limits)."""
    from benchmark import cells

    cell = cells.load_cell("sim10mb-catalog1k.clr20x")
    cell.config.update(TINY_CONFIG)
    cell.mix.update(TINY_MIX)
    return cell


class CpuCard:
    """``run.Card``'s device-only steps on the CPU: nothing to build, no
    CUDA activity, no device memory or trace to read."""

    platform = "cpu"
    chips = 0

    def __init__(self):
        import torch

        self.device = torch.device("cpu")

    def build(self):
        pass

    def activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CPU]

    def reset_peak(self):
        pass

    def peak_bytes(self):
        return None

    def int32_peak(self):
        return None

    def read_trace(self, prof, path):
        return None

    def describe(self):
        return {"platform": self.platform, "kind": "cpu", "count": 0}


def run_tiny(cell, seed, trace=False, seconds=0.0):
    """``run_cell`` on the CPU; returns the result line as a dict."""
    import io
    import json

    from benchmark import run

    out = io.StringIO()
    rc = run.run_cell(cell, seed, seconds, trace, CpuCard(), out=out)
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])
