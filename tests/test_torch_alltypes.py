"""The all-types catalogue on the port (CPU): DEL, INS, INV, intra-
chromosomal BND and reciprocal translocations, direct and inverted, on
several chromosomes, made by the benchmark's generator
(``benchmark/gen_simgenome_alltypes.py``) at a small size.

``python -m svjedi_tpu_torch run`` writes ``python -m svjedi_tpu run``'s
genotype VCF byte for byte; the port's counts are ``correct`` against the
plain reference (``benchmark/reference_simgenome_alltypes.py``) under the
cell's limits; the reference counts hand-built reads of each BND flavour,
an intra-chromosomal BND and an INV as SVJedi-graph does; the align
stage's all-types counters add up; and the audit's fused fetch gives
JAX's audit fields on winners of INV and BND paths.
"""

import dataclasses
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import cells
from benchmark import gen_simgenome_alltypes as galt
from benchmark import reference_simgenome_alltypes as ralt
from svjedi_tpu.align import pipeline as jpipe
from svjedi_tpu.config import AlignConfig as JaxAlignConfig
from svjedi_tpu.io.fastq import ReadSet as JaxReadSet
from svjedi_tpu_torch.align import device as tdev
from svjedi_tpu_torch.align import pipeline as tpipe
from svjedi_tpu_torch.config import AlignConfig
from svjedi_tpu_torch.genotype.filter_gaf import counts_from_informative
from svjedi_tpu_torch.io.fasta import write_fasta

from tests.conftest import REPO_ROOT

# The plain DP runs thousands of tiny ops per call: one thread each is
# faster than many.
torch.set_num_threads(1)

CPU = torch.device("cpu")
CELL = "simgenome-alltypes.ont30x"
#: Five 40 kb chromosomes, 20 records (5 of each type; the BND are one
#: direct and one inverted translocation and one intra-chromosomal
#: junction), ~8x of 3 kb reads.
TINY = {"chroms": {f"chr{i}": 40_000 for i in range(1, 6)},
        "genome_bp": 200_000, "n_svs": 20, "translocations_direct": 1,
        "translocations_inverted": 1}
TINY_MIX = {"coverage": 8, "mean_len": 3000, "sd_len": 1000,
            "max_len": 8000}
SEED = 2**31 + 1919


def tiny_cell():
    cell = cells.load_cell(CELL)
    cell.config.update(TINY)
    cell.mix.update(TINY_MIX)
    return cell


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_alltypes")
    cell = tiny_cell()
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
    return SimpleNamespace(
        vcf=(tmp / "svjedi_tpu_torch_genotype.vcf").read_text(),
        jax_vcf=(tmp / "svjedi_tpu_genotype.vcf").read_text(),
        audit=json.loads(
            open(f"{port}_informative_aln.json").read()),
        stats=json.loads(open(f"{port}_stats.json").read())["counters"])


def test_catalogue_holds_every_type_and_flavour(bundle):
    records = [(r.svtype, r.alt) for r in bundle.cat.records]
    assert {t for t, _ in records} == {"DEL", "INS", "INV", "BND"}
    alts = [a for t, a in records if t == "BND"]
    assert sum(a.startswith("N]") for a in alts) == 1
    assert sum(a.startswith("[") for a in alts) == 1
    names = [r.chrom for r in bundle.cat.records if r.svtype == "BND"]
    mates = [a.strip("N[]").split(":")[0] for a in alts]
    inter = [bundle.cat.names[c] != m for c, m in zip(names, mates)]
    assert sum(inter) == 4 and len(inter) - sum(inter) == 1


def test_port_writes_the_jax_vcf(runs):
    assert runs.vcf == runs.jax_vcf
    bnd = [line.split("\t")[9] for line in runs.vcf.splitlines()
           if "SVTYPE=BND" in line]
    assert len(bnd) == 5 and all(not c.startswith("./.") for c in bnd)


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
    # Every type is counted: the gap of none is the emptiness of its side.
    by_type = {}
    for (t, _), c in zip(ralt._typed_keys(vcf), cols):
        by_type[t] = by_type.get(t, 0) + sum(map(float, c.split(":")[2]
                                                 .split(",")))
    assert min(by_type.values()) > 0, by_type


def test_all_types_counters_add_up(runs):
    s = runs.stats
    by_kind = dict.fromkeys(tpipe.SV_KINDS, 0)
    for tag, (ref, alt) in runs.audit.items():
        kind = tpipe.tag_kind(tag)
        by_kind[tpipe.SV_KINDS[kind]] += len(ref) + len(alt)
    assert s["count_crossings_inv"] == by_kind["INV"] > 0
    assert s["count_crossings_bnd"] == by_kind["BND"] > 0
    assert (s["count_crossings_inv"] + s["count_crossings_bnd"]
            <= s["count_crossings"])
    assert 0 < s["dp_rows_inv_bnd"] <= s["dp_rows"]
    # The gather engine needs no reverse pass on the CPU.
    assert s["rev_rows_inv_bnd"] == s["rev_rows"] == 0
    assert 0 < s["winners_cross_chrom"] <= s["n_winners"]
    assert 0 < s["decoy_s"] <= s["seed_cpu_s"]
    assert s["decoy_suppressed"] >= 0


@pytest.fixture(scope="module")
def aligned(bundle):
    """The port's winners on the bundle (one chunk on the CPU, no audit),
    with its reads and panel."""
    from svjedi_tpu_torch.align.index import build_panel_index
    from svjedi_tpu_torch.config import GenotypeConfig
    from svjedi_tpu_torch.graph.build import build_graph
    from svjedi_tpu_torch.graph.cluster import build_panel
    from svjedi_tpu_torch.graph.svparse import parse_vcf_svs
    from svjedi_tpu_torch.io.fasta import read_fasta
    from svjedi_tpu_torch.io.fastq import read_reads

    cfg = AlignConfig()
    chroms = read_fasta(str(bundle.paths["ref"]))
    parsed = parse_vcf_svs(bundle.paths["vcf"],
                           {c: len(x) for c, x in chroms.items()})
    panel = build_panel(
        build_graph(chroms, parsed), flank=cfg.flank,
        cluster_gap=cfg.cluster_gap,
        max_paths_per_cluster=cfg.max_paths_per_cluster,
        max_hops_per_path=cfg.max_hops_per_path)
    index = build_panel_index(
        panel, k=cfg.kmer, w=cfg.window,
        max_hits_per_minimizer=cfg.max_hits_per_minimizer)
    reads = read_reads(str(bundle.paths["reads"]))
    _, _, winners = tpipe.align_and_count(
        reads, panel, index, cfg, GenotypeConfig(), device=CPU,
        collect_audit=False, chunk_reads=reads.n_reads)
    return reads, panel, winners


@pytest.mark.parametrize("block_rows", [1536, 700])
def test_audit_fused_fetch_matches_jax(aligned, block_rows):
    """``compute_winner_stats`` with the chunk's buffers (the DP fetching
    every piece from them) equals JAX's, on winners of both strands on INV
    and BND paths and on paths across chromosomes."""
    reads, panel, winners = aligned
    table = tpipe.count_table(panel)
    on = table.path_inv_bnd[winners.path]
    assert set(winners.strand[on].tolist()) == {0, 1}
    assert table.path_cross_chrom[winners.path].any()
    fields = {f.name: getattr(winners, f.name)
              for f in dataclasses.fields(jpipe.Winners)}
    jw = jpipe.Winners(**{k: None if v is None else v.copy()
                          for k, v in fields.items()})
    jreads = JaxReadSet(names=reads.names, codes=reads.codes,
                        offsets=reads.offsets)
    jpipe.compute_winner_stats(jreads, panel, jw,
                               JaxAlignConfig(block_rows=block_rows))
    tw = dataclasses.replace(winners)
    timings = {}
    tpipe.compute_winner_stats(reads, panel, tw,
                               AlignConfig(block_rows=block_rows),
                               tdev.upload(reads.codes, panel, CPU),
                               timings=timings)
    assert timings["audit_pieces"] > len(tw.read)
    for f in ("matches", "blocklen", "rescore_deficit", "rescore_flag"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f),
                                      err_msg=f)


# -- hand-built cases ---------------------------------------------------------

#: Two chromosomes of random sequence.
GENOME = [np.random.default_rng(3).integers(0, 4, 30_000, dtype=np.uint8),
          np.random.default_rng(4).integers(0, 4, 20_000, dtype=np.uint8)]
NAMES = ["chrA", "chrB"]


def hand_sample(reads):
    """(hap, slot, start, length) per read."""
    a = np.array(reads, dtype=np.int64).reshape(-1, 4)
    return galt.Sample(hap=a[:, 0], slot=a[:, 1], start=a[:, 2],
                       frag_len=a[:, 3], strand=np.zeros(len(a), np.int64),
                       n_bases=int(a[:, 3].sum()))


#: Per case: the event (genotype 0/1: haplotype 1 carries it), the reads,
#: and the count table the reference must give.
HAND = {
    # chrA 10000 N[chrB:8001[ and chrB 8000 N[chrA:10001[: each record's
    # ref is its own chromosome's junction; reads 50 bases short of a side
    # count nothing.
    "direct": (
        galt.Event(galt.DIRECT, 0, pos=10_000, genotype=1, mate=1,
                   mate_pos=8_000),
        [(0, 0, 9_500, 1_000), (0, 1, 7_000, 2_000), (0, 0, 9_950, 1_000),
         (1, 0, 9_000, 2_000), (1, 1, 7_800, 400), (1, 1, 7_950, 300)],
        {"chrA:BND-10000[chrB:8001[": [1, 1],
         "chrB:BND-8000[chrA:10001[": [1, 1]}),
    # The same event written from chrB's side: its first record is second
    # in VCF order, and the same reads count the same.
    "direct_mate_first": (
        galt.Event(galt.DIRECT, 1, pos=8_000, genotype=1, mate=0,
                   mate_pos=10_000),
        [(0, 0, 9_500, 1_000), (0, 1, 7_000, 2_000), (0, 0, 9_950, 1_000),
         (1, 0, 9_000, 2_000), (1, 1, 7_800, 400), (1, 1, 7_950, 300)],
        {"chrA:BND-10000[chrB:8001[": [1, 1],
         "chrB:BND-8000[chrA:10001[": [1, 1]}),
    # chrA 10000 N]chrB:8000] and chrA 10001 [chrB:8001[N: both records'
    # ref is chrA's junction; chrB's junction counts for neither (the
    # chrom-prefix rule). The second derivative rc(chrB[8000:]) ++
    # chrA[10000:] meets at 12000.
    "inverted": (
        galt.Event(galt.INVERTED, 0, pos=10_000, genotype=1, mate=1,
                   mate_pos=8_000),
        [(0, 0, 9_500, 1_000), (0, 1, 7_500, 1_000), (1, 0, 9_800, 400),
         (1, 1, 11_000, 2_000)],
        {"chrA:BND-10000]chrB:8000]": [1, 1],
         "chrA:BND-[chrB:8001[10001": [1, 1]}),
    # chrA 10000 N[chrA:16001[: two ref junctions, not halved; a read over
    # both counts twice.
    "intra": (
        galt.Event("BND", 0, pos=10_000, length=6_000, genotype=1),
        [(0, 0, 9_500, 1_000), (0, 0, 9_000, 8_000), (0, 0, 15_800, 400),
         (1, 0, 9_000, 2_000)],
        {"chrA:BND-10000[chrA:16001[": [4, 1]}),
    # chrA INV 10000-10500: a read over both ref junctions counts twice; a
    # read with exactly d_over = 100 bases on a side counts.
    "inv": (
        galt.Event("INV", 0, pos=10_000, length=500, genotype=1),
        [(0, 0, 9_500, 1_100), (1, 0, 10_400, 600), (1, 0, 10_401, 600)],
        {"chrA:INV-10000-10500": [2, 1]}),
}


@pytest.mark.parametrize("case", sorted(HAND))
def test_reference_counts_hand_built_reads(tmp_path, case):
    event, reads, want = HAND[case]
    cat = galt.assemble(NAMES, GENOME, [event])
    cat.write_vcf(tmp_path / "c.vcf")
    vcf = (tmp_path / "c.vcf").read_text()
    truth = ralt.truth_counts(cat, hand_sample(reads), 100)
    assert ralt.reference_counts(vcf, truth) == want
