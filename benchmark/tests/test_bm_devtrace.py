"""The frozen device arithmetic: busy share, idle gaps and kernels from a
synthetic trace, their names, and the roofline shares."""

import json

import pytest

from benchmark import cells, devtrace, readers


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


K1 = "void band_dp_v3_kernel<128, false, false>(int)"
K1R = "void band_dp_v3_kernel<128, false, true>(int)"


def test_busy_gaps_kernels_from_a_trace(tmp_path):
    events = [
        ev("job", "user_annotation", 0, 1000),
        ev("stream.next", "user_annotation", 0, 300),
        ev("dispatch_chunk", "user_annotation", 300, 100),
        ev(K1, "kernel", 350, 50),
        ev("Memcpy HtoD", "gpu_memcpy", 380, 40),  # overlaps K1
        ev(K1R, "kernel", 600, 100),
        ev("Memset", "gpu_memset", 900, 10),
        ev("cudaLaunchKernel", "cuda_runtime", 340, 5),
    ]
    tr = devtrace.device_busy(write(tmp_path, events))
    assert tr["window_us"] == 1000
    assert tr["busy_us"] == 70 + 100 + 10
    assert tr["kernels"] == {K1: (50.0, 1), K1R: (100.0, 1)}
    # Gaps: [0,350) 350, [420,600) 180, [700,900) 200, [910,1000) 90.
    assert [g[0] for g in tr["gaps"]] == [350, 200, 180, 90]
    named = devtrace.name_gaps(tr["gaps"], tr["spans"])
    assert named[0] == ("stream.next", 350)
    assert named[1] == ("job", 200)
    idle = cells.metric_reader("device_idle_pct")
    assert idle({"trace": tr}) == pytest.approx(82.0)


def test_no_kernel_event_is_refused(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA kernel event"):
        devtrace.device_busy(write(tmp_path, [ev("x", "cpu_op", 0, 5)]))


def test_kernel_names():
    assert devtrace.kernel_of(K1) == "K1"
    assert devtrace.kernel_of(K1R) == "K1'"
    assert devtrace.kernel_of("_Z17band_dp_v3_kernelILi128ELb0ELb1EEvi") \
        == "K1'"
    assert devtrace.kernel_of("dev_scan_kernel(signed char const*)") == "D1"
    assert devtrace.kernel_of("band_dp_stats_kernel<256, 8, false>") == "A1"
    assert devtrace.kernel_of("elementwise_kernel") is None


def test_roofline_share():
    peak = 132 * 64 * 1.98e9
    # 1 Gcell of K1 at 9 ops: 9e9 / 16.73e12 s = 0.538 ms, operations bind.
    assert devtrace.bound_s(9e9, 1e6, peak) == pytest.approx(9e9 / peak)
    assert devtrace.bound_s(1.0, 3.35e9, peak) == pytest.approx(1e-3)
    tr = {"kernels": {K1: (538.0, 3), K1R: (538.0, 3),
                      "band_dp_stats_kernel<256>": (100.0, 1)}}
    ctx = {"trace": tr, "peak_ops": peak,
           "work": {"K1": [9e9, 1e6], "K1'": [9e9, 1e6], "A1": [0.0, 0.0],
                    "D1": [0.0, 0.0]}}
    share = readers.roofline_pct(ctx, ("K1", "K1'"))
    assert share == pytest.approx(100 * 2 * 9e9 / peak / 1076e-6)
    assert readers.roofline_pct(ctx, ("D1",)) is None  # no D1 time
    assert readers.roofline_pct(dict(ctx, trace=None), ("K1",)) is None
    # A1 spent device time but its probe counted no work: left out, not 0.
    assert readers.roofline_pct(ctx, ("A1",)) is None
    ctx["work"]["K1'"] = [0.0, 0.0]
    assert readers.roofline_pct(ctx, ("K1", "K1'")) is None


def test_missing_timings_leave_the_metric_out():
    from benchmark import run

    jobs = [run.Job(seconds=1.0, ok=True, timings={"seed_s": 0.5},
                    stream_s=0.2),
            run.Job(seconds=1.0, ok=True, timings={"seed_s": 0.3},
                    stream_s=None)]
    seed_wait = cells.metric_reader("seed_wait_ms_per_job")
    assert seed_wait({"jobs": jobs}) == pytest.approx(400.0)
    # A key the program no longer sets, or a stream never pulled, reads
    # nothing rather than 0 ms.
    assert cells.metric_reader("dispatch_ms_per_job")({"jobs": jobs}) is None
    assert cells.metric_reader("stream_ms_per_job")({"jobs": jobs}) is None
    assert seed_wait({"jobs": []}) is None
