"""The window, the rate over whole jobs, and a run's last line, on the CPU
at a tiny size (the harness's look for a card skipped)."""

import time

import pytest

from conftest import run_tiny

from benchmark import run


def test_window_runs_whole_jobs_past_the_deadline():
    def job(i):
        time.sleep(0.05)
        return run.Job(seconds=0.05, ok=i != 2)

    jobs, t0, t1 = run.window(job, 0.2)
    assert len(jobs) >= 4
    assert t1 - t0 >= 0.2 and t1 - t0 < 0.2 + 0.05 + 0.04
    # The failed job's bases do not count; its time does.
    ok = sum(j.ok for j in jobs)
    assert run.mbases_per_s(jobs, 2_000_000, t0, t1) == pytest.approx(
        ok * 2.0 / (t1 - t0))


def test_last_line_keys_untraced_and_traced(tiny_cell):
    res = run_tiny(tiny_cell, 31)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "setup", "host", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"genotype_mbases_per_s", "setup_s"}
    assert res["metrics"]["setup_s"]["unit"] == "s"
    assert set(res["checks"]) == {"ad_gap", "model_mismatch", "failed_jobs"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    # A CPU run never names a device metric as the card's.
    assert res["device"]["platform"] == "cpu"
    assert set(res["setup"]) == {"build_s", "inputs_s", "catalogue_s",
                                 "warm_job_s"}
    assert res["host"]["cpu_s_per_job"] > 0 and res["host"]["cpus"] >= 1
    assert res["host"]["cpu_per_wall"] > 0

    res = run_tiny(tiny_cell, 32, trace=True)
    assert list(res)[-1] == "checks" and res["correct"] is True
    got = set(res["metrics"])
    assert {"stream_ms_per_job", "seed_cpu_ms_per_job",
            "audit_assembly_ms_per_job", "genotype_ms_per_job",
            "host_peak_gb"} <= got
    # Device metrics have no CPU reading: left out, never 0.
    assert not got & {"dp_roofline_pct", "audit_dp_roofline_pct",
                      "scan_roofline_pct", "device_idle_pct",
                      "device_peak_gb"}


def test_no_card_exits_without_a_result(capsys):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    rc = run.main(["--workload", "sim10mb-catalog1k.clr20x", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""


@pytest.mark.gpu
def test_a_cell_runs_on_the_card(capsys):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rc = run.main(["--workload", "sim10mb-catalog1k.clr20x", "--seed", "7",
                   "--seconds", "2"])
    import json

    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] and res["device"]["platform"] == "gpu"

