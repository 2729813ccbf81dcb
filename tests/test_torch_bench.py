"""``python -m svjedi_tpu_torch.bench`` on the CPU (``--device cpu``).

A tiny scale configuration must print exactly one parseable JSON line with
the scale metric and a positive value; the golden configuration without its
files must print the error line and exit 1; without a card and without
``--device cpu`` the bench must refuse to run.

The bench builds the port's native library into its package's
``kernels/_build``; it runs here from a copy of the package, so that the
library stays out of the checkout, where it would switch the host path of
the other tests' runs.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from tests.conftest import REPO_ROOT


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
