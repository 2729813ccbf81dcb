"""``python -m svjedi_tpu_torch`` end to end vs ``python -m svjedi_tpu`` (CPU).

On the CPU (``--device cpu``) both packages score with the one-pass
``gather`` engine, so the GAF, the audit table and the genotype VCF must be
byte-identical on a simulated bundle; the port's shard + merge mode must
reproduce its single run; the port must import and run with JAX and the JAX
package absent; and without ``--device cpu`` it must refuse to run when no
card is visible.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svjedi_tpu.io import sim
from svjedi_tpu.io.fasta import write_fasta
from svjedi_tpu_torch.cli import main as torch_cli
from svjedi_tpu_torch.config import DistConfig, PipelineConfig

from tests.conftest import REPO_ROOT

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many, and keeps parallel test workers off each other's cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    s = sim.simulate(
        seed=5, chrom_lengths={"chrA": 30000, "chrB": 25000}, n_svs=8,
        sv_types=("DEL", "INS", "INV"),
    )
    names, seqs = sim.simulate_reads(
        np.random.default_rng(5), s.haplotypes, coverage=12.0,
        mean_len=3000, sd_len=1000,
    )
    paths = {"vcf": tmp / "truth.vcf", "ref": tmp / "ref.fasta",
             "reads": tmp / "reads.fastq"}
    sim.write_truth_vcf(s, paths["vcf"])
    write_fasta(paths["ref"], s.chroms)
    sim.write_fastq(paths["reads"], names, seqs)
    return tmp, paths


@pytest.fixture(scope="module")
def single_runs(bundle):
    """One run of each CLI with ``--gaf``, side by side in two processes."""
    tmp, paths = bundle
    base = ["run", "-v", str(paths["vcf"]), "-r", str(paths["ref"]),
            "-q", str(paths["reads"])]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO_ROOT),
               OMP_NUM_THREADS="1")
    device = {"svjedi_tpu": [], "svjedi_tpu_torch": ["--device", "cpu"]}
    procs = {
        pkg: subprocess.Popen(
            [sys.executable, "-m", pkg, *base, "-p", str(tmp / pkg), "--gaf",
             *device[pkg]],
            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
        )
        for pkg in ("svjedi_tpu", "svjedi_tpu_torch")
    }
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{pkg}:\n{out}\n{err}"
    return tmp


def test_cli_run_matches_jax_vcf(single_runs):
    tmp = single_runs
    ours = (tmp / "svjedi_tpu_torch_genotype.vcf").read_bytes()
    theirs = (tmp / "svjedi_tpu_genotype.vcf").read_bytes()
    assert ours == theirs
    assert b"0/1" in ours or b"1/1" in ours
    stats = json.loads((tmp / "svjedi_tpu_torch_stats.json").read_text())
    assert stats["counters"]["seed_path"] == "host"
    assert stats["counters"]["device"] == "cpu"
    assert stats["counters"]["engine"] == "gather"  # the JAX CPU engine
    assert stats["counters"]["band_dp_v3_launches"] == 0
    assert stats["counters"]["band_dp_v3_rev_launches"] == 0
    assert "native_lib" in stats["counters"]
    assert stats["counters"]["band_dp_dma_launches"] == 0


@pytest.mark.parametrize("suffix", [".gaf", "_informative_aln.json"])
def test_cli_run_matches_jax_alignments(single_runs, suffix):
    """Winners' spans, hence the GAF and the audit table, equal the JAX
    package's byte for byte."""
    ours = (single_runs / f"svjedi_tpu_torch{suffix}").read_bytes()
    theirs = (single_runs / f"svjedi_tpu{suffix}").read_bytes()
    assert len(ours) > 0
    assert ours == theirs


def test_shard_merge_and_resume_match_single_run(bundle, single_runs):
    tmp, paths = bundle
    base = ["-v", str(paths["vcf"]), "-r", str(paths["ref"]),
            "-q", str(paths["reads"]), "--device", "cpu"]
    sharded = str(tmp / "sharded")
    assert torch_cli(["run", *base, "-p", sharded, "--shard", "0/2"]) == 0
    assert torch_cli(["run", *base, "-p", sharded, "--shard", "1/2",
                      "--decoy-shards", "2"]) == 0
    assert torch_cli(["merge", "-v", base[1], "-p", sharded, "-n", "2"]) == 0
    single = (tmp / "svjedi_tpu_torch_genotype.vcf").read_bytes()
    assert (tmp / "sharded_genotype.vcf").read_bytes() == single
    # --resume genotypes from the merged audit table without aligning.
    (tmp / "sharded_genotype.vcf").unlink()
    assert torch_cli(["run", *base, "-p", sharded, "--resume"]) == 0
    assert (tmp / "sharded_genotype.vcf").read_bytes() == single
    stats = json.loads((tmp / "sharded_stats.json").read_text())
    assert "resumed_from" in stats["counters"]


@pytest.mark.parametrize(
    "dist, multihost",
    [(DistConfig(data_shards=2), False), (DistConfig(graph_shards=2), False),
     (DistConfig(), True)],
)
def test_unported_modes_raise(dist, multihost):
    from svjedi_tpu_torch.pipeline import run_pipeline

    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_pipeline(PipelineConfig(dist=dist, multihost=multihost))


def test_entry_points_need_a_card_unless_asked_for_the_cpu(
        bundle, monkeypatch):
    """No card visible: ``run_pipeline`` and ``run`` without ``--device cpu``
    raise, naming the way to ask for the CPU; nothing falls back."""
    from svjedi_tpu_torch import pipeline

    tmp, paths = bundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = PipelineConfig(vcf=str(paths["vcf"]), ref=str(paths["ref"]),
                         reads=(str(paths["reads"]),), prefix=str(tmp / "nocard"))
    for call in (lambda: pipeline.select_device(),
                 lambda: pipeline.run_pipeline(cfg),
                 lambda: torch_cli(["run", "-v", str(paths["vcf"]), "-r",
                                    str(paths["ref"]), "-q", str(paths["reads"]),
                                    "-p", str(tmp / "nocard")])):
        with pytest.raises(RuntimeError, match="--device cpu") as err:
            call()
        assert 'device=torch.device("cpu")' in str(err.value)
    assert not (tmp / "nocard_stats.json").exists()
    proc = subprocess.run(
        [sys.executable, "-m", "svjedi_tpu_torch", "run", "-v", str(paths["vcf"]),
         "-r", str(paths["ref"]), "-q", str(paths["reads"]),
         "-p", str(tmp / "nocard")],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT), CUDA_VISIBLE_DEVICES=""),
    )
    assert proc.returncode != 0
    assert "--device cpu" in proc.stderr


def test_chip_smoke_imports_nothing_of_the_jax_package():
    tree = ast.parse((REPO_ROOT / "chip_smoke.py").read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
    assert "svjedi_tpu_torch.pipeline" in names  # the scan sees its imports
    bad = [n for n in names if n.split(".")[0] in ("svjedi_tpu", "jax")
           or n.startswith(".")]
    assert not bad, bad


def test_port_imports_and_runs_without_jax():
    code = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
sys.modules["svjedi_tpu"] = None  # and any import of the JAX package
import numpy as np, torch
import svjedi_tpu_torch
for mod in pkgutil.walk_packages(svjedi_tpu_torch.__path__, "svjedi_tpu_torch."):
    importlib.import_module(mod.name)
from svjedi_tpu_torch.kernels.band_dp_v3 import band_dp_v3_fwd
rng = np.random.default_rng(0)
q = torch.from_numpy(rng.integers(0, 4, (64, 128)).astype(np.int8))
t = torch.cat([q, torch.full((128, 128), 4, dtype=torch.int8)])
out = band_dp_v3_fwd(q, t, 64, 128)
assert out.shape == (128, 3) and bool((out[:, 0] == 128).all()), out[:4]
from svjedi_tpu_torch.kernels.band_dp import band_dp_onepass
one = band_dp_onepass(q.T.contiguous(), t.T.contiguous(), 128)
assert bool((one["score"] == 128).all()), one["score"][:4]
loaded = [m for m in sys.modules if sys.modules[m] is not None]
assert not any(m == "jax" or m.startswith("jax.") for m in loaded)
assert not any(m == "svjedi_tpu" or m.startswith("svjedi_tpu.") for m in loaded)
print("ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO_ROOT)),
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
