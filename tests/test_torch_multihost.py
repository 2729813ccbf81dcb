"""The port's multi-process layer and the distribution modes of ``run`` (CPU).

``dist/multihost.py`` without a group (``initialize`` is (0, 1), the read
block is everything, the count merge is the identity) and its refusals;
``run_pipeline`` with ``--multihost`` in one process, with
``--data-shards 4`` (a list of four CPU devices) and with ``--data-shards
4 --graph-shards 2`` (eight): each VCF byte-equal to the port's plain run
and to the JAX package's run in the same mode, on the bundle of
``tests/test_multihost.py``. Then two processes of ``python -m
svjedi_tpu_torch run --multihost`` in a gloo group on 127.0.0.1: process
0's VCF byte-equal to the single run.
"""

import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from svjedi_tpu.config import DistConfig as JaxDistConfig
from svjedi_tpu.config import PipelineConfig as JaxPipelineConfig
from svjedi_tpu.pipeline import run_pipeline as jax_run_pipeline
from svjedi_tpu_torch.config import DistConfig, PipelineConfig
from svjedi_tpu_torch.dist import multihost as mh
from svjedi_tpu_torch.pipeline import run_pipeline

from tests.conftest import REPO_ROOT
from test_multihost import _sim_inputs

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def no_group_env(monkeypatch):
    for key in mh.ENV:
        monkeypatch.delenv(key, raising=False)


def test_initialize_without_coordinator(no_group_env, capsys):
    assert mh.initialize() == (0, 1)
    assert "no cluster configuration; running single-process" in \
        capsys.readouterr().err
    assert not torch.distributed.is_initialized()


def test_initialize_refuses_what_it_cannot_apply(no_group_env, monkeypatch):
    with pytest.raises(ValueError, match="num_processes, process_id"):
        mh.initialize(coordinator_address="127.0.0.1:1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(ValueError, match="MASTER_PORT, WORLD_SIZE, RANK unset"):
        mh.initialize()
    assert not torch.distributed.is_initialized()


def test_process_read_block_single():
    assert mh.process_read_block(100) == (0, 100)
    assert mh.rank_device(CPU) == CPU


def test_allreduce_identity_single_process():
    counts = {"a": [1, 2], "b": [0, 5]}
    assert mh.allreduce_counts(counts) == counts


def test_allreduce_reports_and_raises_a_failed_barrier(monkeypatch, capsys):
    def barrier(timeout):
        assert timeout == mh.TIMEOUT
        raise RuntimeError("rank 1 failed to pass monitoredBarrier")

    monkeypatch.setattr(mh, "_membership", lambda: (0, 2))
    monkeypatch.setattr(mh.dist, "monitored_barrier", barrier)
    with pytest.raises(RuntimeError, match="monitoredBarrier"):
        mh.allreduce_counts({"a": [1, 2]})
    err = capsys.readouterr().err
    assert "process 0/2: the barrier before the count allreduce failed" in err


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_multihost")
    vcf, fa, fq = _sim_inputs(tmp)
    plain = run_pipeline(
        PipelineConfig(vcf=vcf, ref=fa, reads=(str(fq),),
                       prefix=str(tmp / "plain"), keep_artifacts=False),
        device=CPU)
    return tmp, (vcf, fa, fq), open(plain["output_vcf"]).read()


@pytest.mark.parametrize("mode, n_devices, counters", [
    ("multihost", 1, {"process": "0/1"}),
    ("data_shards", 4, {"data_shards": 4}),
    ("mesh", 8, {"data_shards": 4, "mesh": "4x2"}),
])
def test_run_modes_match_plain_and_jax(bundle, no_group_env, mode,
                                       n_devices, counters):
    tmp, (vcf, fa, fq), plain = bundle
    dist = {"multihost": {}, "data_shards": {"data_shards": 4},
            "mesh": {"data_shards": 4, "graph_shards": 2}}[mode]
    kw = dict(vcf=vcf, ref=fa, reads=(str(fq),), keep_artifacts=False,
              multihost=mode == "multihost")
    ours = run_pipeline(
        PipelineConfig(prefix=str(tmp / f"port_{mode}"),
                       dist=DistConfig(**dist), **kw),
        device=CPU, devices=[CPU] * n_devices)
    theirs = jax_run_pipeline(JaxPipelineConfig(
        prefix=str(tmp / f"jax_{mode}"), dist=JaxDistConfig(**dist), **kw))
    for key, value in counters.items():
        assert ours["stats"].counters.get(key) == value, key
        assert theirs["stats"].counters.get(key) == value, key
    vcf_out = open(ours["output_vcf"]).read()
    assert vcf_out == plain
    assert vcf_out == open(theirs["output_vcf"]).read()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_multihost_equals_single(bundle):
    """Two ``run --multihost`` processes in a gloo group: each aligns half of
    the reads, the count tables are summed, process 0 genotypes."""
    tmp, (vcf, fa, fq), plain = bundle
    port = _free_port()
    prefix = tmp / "two"
    cmd = [sys.executable, "-m", "svjedi_tpu_torch", "run", "-v", str(vcf),
           "-r", str(fa), "-q", str(fq), "-p", str(prefix), "--device",
           "cpu", "--multihost"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), PYTHONPATH=str(REPO_ROOT),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            cmd, cwd=str(tmp), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + 300
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    assert "Genotyped svs" in outs[0][0]
    assert "genotyping runs on process 0" in outs[1][0]
    assert open(f"{prefix}_genotype.vcf").read() == plain
    assert (tmp / "two.host1_stats.json").exists()
