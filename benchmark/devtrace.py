"""The yardstick's device arithmetic: the card's int32 peak, the roofline
bound of a kernel's work, and the busy share, kernels and idle gaps of a
``torch.profiler`` trace.

Frozen copies, so that later changes to the program cannot move them:

- ``HBM_BYTES_PER_S``, ``INT32_LANES_PER_SM`` and ``OPS_PER_CELL`` from
  ``chip_smoke.py:223-234``; ``SCAN_OPS_WINDOW_PER_POSITION`` from
  ``chip_smoke.py:929-937``;
- :func:`int32_peak` from ``chip_smoke.py:258-275`` (``phase_device``);
- :func:`bound_s` from ``chip_smoke.py:400-405`` (``bound_ms``), in seconds;
- :func:`kernel_of` from ``chip_smoke.py:2169-2184``;
- :func:`device_busy` from ``chip_smoke.py:2187-2227``, without its check
  for ``run``'s four kernels, with each gap's start kept so that
  :func:`name_gaps` can name it by the host span that covers it.
"""

from __future__ import annotations

import json
import re
import subprocess

#: H100 SXM memory rate (NVIDIA's data sheet), for the bytes side of a bound.
HBM_BYTES_PER_S = 3.35e12
#: int32 lanes per SM per clock on Hopper (4 partitions x 16).
INT32_LANES_PER_SM = 64
#: int32 operations per band cell as Hopper issues them: K1 and K1' (the v3
#: passes) 9; the one-pass kernels 14; the audit's stats DP (A1) 15.
OPS_PER_CELL = {"k1": 9, "onepass": 14, "stats": 15, "band_dp_gather": 14}
#: Operations per scanned position of the minimizer scan D1 in the
#: sliding-window formulation the kernel runs.
SCAN_OPS_WINDOW_PER_POSITION = 37


def int32_peak() -> float:
    """SMs x 64 int32 lanes x the maximum SM clock nvidia-smi reports, of
    card 0."""
    import torch

    clk = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    max_sm_hz = float(clk.stdout.strip().splitlines()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return n_sm * INT32_LANES_PER_SM * max_sm_hz


def bound_s(ops: float, n_bytes: float, peak_ops: float) -> float:
    """The least time for the work: the larger of operations over the int32
    peak and bytes over the memory rate."""
    return max(ops / peak_ops, n_bytes / HBM_BYTES_PER_S)


def kernel_of(name: str):
    """Which of ``run``'s kernels a trace's kernel event is (demangled or
    mangled name), or None; K1' is the kRev build of band_dp_v3_kernel."""
    if "dev_scan_kernel" in name:
        return "D1"
    if "band_dp_stats_kernel" in name:
        return "A1"
    if "band_dp_v3_kernel" in name:
        args = re.search(r"band_dp_v3_kernel<([^>]*)>", name)
        if args:
            rev = args.group(1).split(",")[-1].strip() == "true"
        else:
            rev = re.search(r"band_dp_v3_kernelI.*?Lb([01])EE", name)
            rev = rev is not None and rev.group(1) == "1"
        return "K1'" if rev else "K1"
    return None


def device_busy(trace_path) -> dict:
    """From a torch.profiler trace: the union of the device's kernel, memcpy
    and memset intervals over the profiled window (the span of all the
    trace's events), the kernels by total time and the longest idle gaps
    (length, start), in microseconds. Raises if the trace holds no kernel
    event (no CUDA tracing)."""
    with open(trace_path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    gpu = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kernels = [e for e in gpu if e["cat"] == "kernel"]
    if not kernels:
        raise RuntimeError(f"the profiler trace holds no CUDA kernel event "
                           f"({len(events)} events): torch.profiler did not "
                           f"trace the card")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    merged = []
    for s, e in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in gpu):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    edges = [t0] + [x for span in merged for x in span] + [t1]
    gaps = sorted(((edges[2 * i + 1] - edges[2 * i], edges[2 * i])
                   for i in range(len(merged) + 1)), reverse=True)
    by_name: dict = {}
    for e in kernels:
        tot, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + float(e["dur"]), n + 1)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"]
    return {"window_us": t1 - t0, "busy_us": busy, "kernels": by_name,
            "gaps": gaps[:10], "spans": spans}


def name_gaps(gaps, spans):
    """Each (length, start) gap named by the innermost host span that
    covers its middle (the harness's ``record_function`` ranges), or
    ``"outside any span"``."""
    named = []
    for length, start in gaps:
        mid = start + length / 2
        cover = [(e - s, name) for s, e, name in spans if s <= mid <= e]
        named.append((min(cover)[1] if cover else "outside any span", length))
    return named
