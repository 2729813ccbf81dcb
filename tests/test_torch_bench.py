"""``python -m svjedi_tpu_torch.bench`` on the CPU (``--device cpu``).

A tiny scale configuration must print exactly one parseable JSON line with
the scale metric and a positive value; the golden configuration without its
files must print the error line and exit 1; without a card and without
``--device cpu`` the bench must refuse to run. With ``SVJT_SCALE_MEMLOG``
the scale configuration writes the JAX bench's phase-tagged RSS profile
from one sampler thread, which it stops after the last pass; without it
no sampler starts and no file is written.

The bench builds the port's native library into its package's
``kernels/_build``; it runs here from a copy of the package, so that the
library stays out of the checkout, where it would switch the host path of
the other tests' runs.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from svjedi_tpu_torch.bench import MEMLOG_PHASES
from tests.conftest import REPO_ROOT

#: Small scale configuration: a 1 Mb genome, 5 SVs, 2x.
SMALL_SCALE = {"SVJT_BENCH_CONFIG": "scale", "SVJT_SCALE_MB": "1",
               "SVJT_SCALE_SVS": "5", "SVJT_SCALE_COV": "2",
               "SVJT_SCALE_MIN_ACC": "0"}
#: Runs the bench's main() and reports, on its last stderr line, the name
#: of every Python thread the process started.
THREAD_TRACE = """
import sys, threading
started = []
_start = threading.Thread.start
def start(self):
    started.append(self.name)
    return _start(self)
threading.Thread.start = start
from svjedi_tpu_torch import bench
rc = bench.main(sys.argv[1:])
print("[threads] " + ",".join(started), file=sys.stderr)
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def package_copy(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench_pkg")
    shutil.copytree(REPO_ROOT / "svjedi_tpu_torch", root / "svjedi_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    return root


def _bench(root, env_extra, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1",
               **env_extra)
    return subprocess.run(
        [sys.executable, "-m", "svjedi_tpu_torch.bench", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=timeout,
    )


def test_scale_config_prints_one_json_line(package_copy):
    proc = _bench(package_copy,
                  {"SVJT_BENCH_CONFIG": "scale", "SVJT_SCALE_MB": "1",
                   "SVJT_SCALE_SVS": "5", "SVJT_SCALE_COV": "2",
                   "SVJT_SCALE_MIN_ACC": "0", "SVJT_SCALE_ONE_PASS": "1"},
                  "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    result = json.loads(lines[0])
    assert result["metric"] == "scale_reads_per_s_per_chip"
    assert result["unit"] == "reads/s"
    assert result["value"] > 0 and result["vs_baseline"] > 0
    assert "[scale] genome=1Mb" in proc.stderr
    assert "[bench] warm" in proc.stderr and "seed_s=" in proc.stderr
    assert "seed_path=device" in proc.stderr  # the bench built the library
    assert (package_copy / "svjedi_tpu_torch" / "kernels" / "_build"
            / "libsvtfastio.so").exists()


def test_golden_config_without_its_files_fails_with_error_line(package_copy,
                                                              tmp_path):
    proc = _bench(package_copy, {"SVJT_BENCH_CONFIG": "golden",
                                 "SVJT_TESTDIR": str(tmp_path)},
                  "--device", "cpu")
    assert proc.returncode == 1
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    result = json.loads(lines[0])
    assert result["metric"] == "reads_per_s_per_chip"
    assert result["value"] == 0.0 and "error" in result


def test_refuses_without_a_card_unless_asked_for_the_cpu(package_copy):
    proc = _bench(package_copy, {"SVJT_BENCH_CONFIG": "scale",
                                 "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr
    assert proc.stdout.strip() == ""


def _bench_threads(root, cwd, env_extra, *args, timeout=300):
    """The bench run under THREAD_TRACE from ``cwd``: (process, names of
    the threads it started)."""
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="1",
               **env_extra)
    proc = subprocess.run(
        [sys.executable, "-c", THREAD_TRACE, *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout,
    )
    last = proc.stderr.strip().splitlines()[-1]
    assert last.startswith("[threads] "), proc.stderr
    return proc, last[len("[threads] "):].split(",")


def _scale_line(stderr: str) -> str:
    return next(ln for ln in stderr.splitlines() if ln.startswith("[scale]"))


def test_scale_memlog_writes_the_jax_phase_profile(package_copy, tmp_path):
    """Header, rows of (t_s, rss_gb, phase) and every phase label in the
    JAX bench's order, align_timed last (two passes); one sampler thread;
    post_align_resident_gb on the [scale] line."""
    memlog = tmp_path / "mem.tsv"
    proc, threads = _bench_threads(
        package_copy, package_copy,
        {**SMALL_SCALE, "SVJT_SCALE_ONE_PASS": "0",
         "SVJT_SCALE_MEMLOG": str(memlog)},
        "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert len(proc.stdout.strip().splitlines()) == 1, proc.stdout
    assert "[bench] timed" in proc.stderr
    assert threads.count("svjt-scale-memlog") == 1
    lines = memlog.read_text().splitlines()
    assert lines[0] == "t_s\trss_gb\tphase"
    rows = [ln.split("\t") for ln in lines[1:]]
    assert rows and all(len(r) == 3 for r in rows)
    t_s = [float(r[0]) for r in rows]
    assert t_s == sorted(t_s) and t_s[0] >= 0
    assert all(float(r[1]) >= 0 for r in rows)
    assert all(r[0] == f"{float(r[0]):.1f}" and r[1] == f"{float(r[1]):.2f}"
               for r in rows)
    labels = [r[2] for r in rows]
    order = [lab for i, lab in enumerate(labels)
             if i == 0 or lab != labels[i - 1]]
    if order[0] == "start":  # the sampler's first row may precede "sim"
        order = order[1:]
    assert order == list(MEMLOG_PHASES[1:])
    assert labels[-1] == "align_timed"
    scale = _scale_line(proc.stderr)
    resident = re.search(r"post_align_resident_gb=([\d.]+)", scale)
    assert resident and float(resident.group(1)) > 0, scale


def test_scale_without_memlog_starts_no_sampler(package_copy, tmp_path):
    proc, threads = _bench_threads(
        package_copy, tmp_path, {**SMALL_SCALE, "SVJT_SCALE_ONE_PASS": "1"},
        "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert "svjt-scale-memlog" not in threads
    assert list(tmp_path.iterdir()) == []
    assert "post_align_resident_gb=" in _scale_line(proc.stderr)
