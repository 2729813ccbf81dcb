"""The repeat-rich catalogue on the port (CPU): the benchmark's all-types
catalogue over Alu-like, L1-like and tandem-repeat copies with
mobile-element SVs (``benchmark/gen_simgenome_repeats.py``) at a small
size.

``python -m svjedi_tpu_torch run`` writes ``python -m svjedi_tpu run``'s
genotype VCF byte for byte; its counts are ``correct`` against the plain
reference (``benchmark/reference_simgenome_alltypes.py``) under the cell's
limits; the index hit cap drops minimizers of the repeats; and the repeats'
counters see work: ``decoy_chains`` and ``chain_anchors`` above 0, and
``density_dropped`` counted (this bundle's winners all score at least
0.6 per base, above the floor's 0.5, so it reads 0 here).
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import cells
from benchmark import reference_simgenome_alltypes as ralt
from svjedi_tpu_torch.align.decoy import build_decoy
from svjedi_tpu_torch.align.index import build_panel_index
from svjedi_tpu_torch.align.minimizer import extract_minimizers
from svjedi_tpu_torch.config import AlignConfig
from svjedi_tpu_torch.genotype.filter_gaf import counts_from_informative
from svjedi_tpu_torch.graph.build import build_graph
from svjedi_tpu_torch.graph.cluster import build_panel
from svjedi_tpu_torch.graph.svparse import parse_vcf_svs
from svjedi_tpu_torch.io.fasta import write_fasta

from tests.conftest import REPO_ROOT

CELL = "simgenome-repeats.ont30x"
#: Five 40 kb chromosomes, 20 records (5 of each type; the BND are one
#: direct and one inverted translocation and one intra-chromosomal
#: junction), ~4x of 3 kb reads; ~70 Alu-like and ~37 L1-like copies.
TINY = {"chroms": {f"chr{i}": 40_000 for i in range(1, 6)},
        "genome_bp": 200_000, "n_svs": 20, "translocations_direct": 1,
        "translocations_inverted": 1}
TINY_MIX = {"coverage": 4, "mean_len": 3000, "sd_len": 1000,
            "max_len": 8000}
SEED = 2**31 + 1919


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_repeats")
    cell = cells.load_cell(CELL)
    cell.config.update(TINY)
    cell.mix.update(TINY_MIX)
    cat = cell.gen.make_catalogue(cell.config, SEED)
    paths = {"vcf": tmp / "catalogue.vcf", "ref": tmp / "ref.fasta",
             "reads": tmp / "reads.fastq"}
    cat.write_vcf(paths["vcf"])
    write_fasta(paths["ref"], cat.fasta_dict())
    sample = cell.gen.make_sample(cat, cell.mix, SEED, paths["reads"])
    return SimpleNamespace(tmp=tmp, cell=cell, cat=cat, sample=sample,
                           paths=paths)


@pytest.fixture(scope="module")
def runs(bundle):
    """One run of each CLI on the bundle, side by side in two processes."""
    tmp, paths = bundle.tmp, bundle.paths
    base = ["run", "-v", str(paths["vcf"]), "-r", str(paths["ref"]),
            "-q", str(paths["reads"])]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO_ROOT),
               OMP_NUM_THREADS="1")
    device = {"svjedi_tpu": [], "svjedi_tpu_torch": ["--device", "cpu"]}
    procs = {
        pkg: subprocess.Popen(
            [sys.executable, "-m", pkg, *base, "-p", str(tmp / pkg),
             *device[pkg]],
            cwd=REPO_ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        for pkg in ("svjedi_tpu", "svjedi_tpu_torch")
    }
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{pkg}:\n{out}\n{err}"
    port = tmp / "svjedi_tpu_torch"
    stats = json.loads(open(f"{port}_stats.json").read())
    return SimpleNamespace(
        vcf=(tmp / "svjedi_tpu_torch_genotype.vcf").read_text(),
        jax_vcf=(tmp / "svjedi_tpu_genotype.vcf").read_text(),
        audit=json.loads(open(f"{port}_informative_aln.json").read()),
        stats=stats["counters"])


def test_catalogue_is_repeat_rich(bundle):
    cat, rep = bundle.cat, bundle.cell.config["repeats"]
    copies = cat.copies
    for f, name in enumerate(("alu", "l1", "tandem")):
        share = copies.length[copies.family == f].sum() / cat.genome_bp
        assert abs(share - rep[name]["share"]) < 0.01, name
    assert (copies.family == 0).sum() > 64
    kinds = [k for k, _ in cat.mobile.values()]
    assert kinds.count("INS") == 2 and kinds.count("DEL") == 1


def test_port_writes_the_jax_vcf(runs):
    assert runs.vcf == runs.jax_vcf
    assert sum(1 for line in runs.vcf.splitlines()
               if not line.startswith("#")) == 20


def test_port_counts_are_correct_against_the_reference(bundle, runs):
    cell, g = bundle.cell, bundle.cell.config["guarantees"]
    vcf = bundle.paths["vcf"].read_text()
    truth = ralt.truth_counts(bundle.cat, bundle.sample, g["d_over"])
    cols = ralt.expected_columns(vcf, ralt.reference_counts(vcf, truth),
                                 g["min_support"], g["err"])
    got = ralt.compare(vcf, runs.vcf, counts_from_informative(runs.audit),
                       cols, g["min_support"], g["err"])
    assert got["model_mismatch"] == 0
    assert got["ad_gap"] <= cell.limits["ad_gap"], got


def test_repeat_counters_see_work(runs):
    s = runs.stats
    # Every read competes with its own locus in the decoy, and a read over
    # a repeat with the repeat's other copies.
    assert s["decoy_chains"] > s["n_candidates"] > 0
    assert s["decoy_suppressed"] > 0
    assert s["chain_anchors"] >= 2 * s["n_candidates"]
    assert type(s["density_dropped"]) is int and s["density_dropped"] >= 0
    assert 0 < s["chain_s"] <= s["seed_cpu_s"]


def dropped(hash_arrays, cap):
    """Hits of minimizers occurring more than ``cap`` times, and all
    hits, of the hashes the index builders sort."""
    _, n = np.unique(np.concatenate(hash_arrays), return_counts=True)
    return int(n[n > cap].sum()), int(n.sum())


def test_hit_cap_drops_repeat_minimizers(bundle):
    """The cap (``max_hits_per_minimizer``) drops hits from the decoy's
    whole-genome index and from the panel's index (whose paths share their
    flanks), where the poly-A tails and short-unit tandem arrays repeat
    one k-mer more than 64 times; the indexes hold exactly the hits it
    keeps."""
    cfg = AlignConfig()
    chroms = bundle.cat.fasta_dict()
    parsed = parse_vcf_svs(bundle.paths["vcf"],
                           {c: len(x) for c, x in chroms.items()})
    panel = build_panel(
        build_graph(chroms, parsed), flank=cfg.flank,
        cluster_gap=cfg.cluster_gap,
        max_paths_per_cluster=cfg.max_paths_per_cluster,
        max_hops_per_path=cfg.max_hops_per_path)
    cap = cfg.max_hits_per_minimizer
    k, w = cfg.kmer, cfg.window
    gone, hits = dropped([extract_minimizers(g, k, w).hash
                          for g in bundle.cat.genome], cap)
    decoy = build_decoy(panel, k=k, w=w, max_hits_per_minimizer=cap)
    assert gone > 0 and len(decoy.index.hit_pos) == hits - gone
    gone, hits = dropped([extract_minimizers(p.seq, k, w).hash
                          for p in panel.paths], cap)
    index = build_panel_index(panel, k=k, w=w, max_hits_per_minimizer=cap)
    assert gone > 0 and len(index.hit_pos) == hits - gone
