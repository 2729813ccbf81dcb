"""The all-types configuration's generator and reference
(``gen_simgenome_alltypes.py``, ``reference_simgenome_alltypes.py``): the
same work for every seed, places that never fail, derivative haplotypes
that hold every junction the reference counts, a VCF the port takes whole,
and a control that is not correct."""

import json

import numpy as np
import pytest

from conftest import ROOT

from benchmark import calibrate, cells
from benchmark import gen_simgenome_alltypes as galt
from benchmark import reference_simgenome_alltypes as ralt

CELL = "simgenome-alltypes.ont30x"
#: Six small chromosomes and 24 records: one direct and one inverted
#: translocation, two intra-chromosomal BND.
SMALL = {"chroms": {f"c{i}": 36_000 + 4_000 * i for i in range(6)},
         "genome_bp": 276_000, "n_svs": 24, "translocations_direct": 1,
         "translocations_inverted": 1}
SMALL_MIX = {"coverage": 6, "mean_len": 3000, "sd_len": 1000,
             "max_len": 8000}
K = 60  # bases of context either side of a junction


def config(**over):
    cfg = json.loads(
        (ROOT / "benchmark/configs/simgenome-alltypes.json").read_text())
    cfg["name"] = "simgenome-alltypes"
    cfg.update(over)
    return cfg


def mix(**over):
    m = json.loads((ROOT / "benchmark/mixes/ont30x.json").read_text())
    m["name"] = "ont30x"
    m.update(SMALL_MIX, **over)
    return m


def make(seed, tmp_path, **over):
    cat = galt.make_catalogue(config(**SMALL), seed)
    path = tmp_path / f"s{seed}.fastq"
    sample = galt.make_sample(cat, mix(**over), seed, path)
    return cat, sample, path.read_bytes()


def test_same_seed_same_inputs(tmp_path):
    seed = 2**31 + 4321
    a, sa, fa = make(seed, tmp_path)
    b, sb, fb = make(seed, tmp_path)
    assert fa == fb and all(np.array_equal(x, y)
                            for x, y in zip(a.genome, b.genome))
    assert [(r.chrom, r.pos, r.alt) for r in a.records] == \
        [(r.chrom, r.pos, r.alt) for r in b.records]
    c, _, fc = make(seed + 1, tmp_path)
    assert fc != fa


def test_multisets_are_fixed_by_the_names(tmp_path):
    a, sa, _ = make(3, tmp_path)
    b, sb, _ = make(-4, tmp_path)

    def multisets(cat):
        ev = cat.events
        return (sorted(r.svtype for r in cat.records),
                sorted((e.kind, e.length) for e in ev),
                sorted((e.kind, e.genotype) for e in ev),
                sorted(r.alt[0] + r.alt[-1] for r in cat.records
                       if r.svtype == "BND"))

    assert multisets(a) == multisets(b)
    assert sorted(galt.read_lengths(mix(), a.genome_bp)) == sorted(
        galt.read_lengths(mix(), b.genome_bp))
    assert abs(sa.n_bases - sb.n_bases) < 0.02 * sa.n_bases
    # The full configuration: 250 of each type, the BND 24 + 226.
    full = galt.make_catalogue(config(), 5)
    kinds = [e.kind for e in full.events]
    assert [kinds.count(k) for k in ("DEL", "INS", "INV", "BND", "TRA",
                                     "TRA_INV")] == [250, 250, 250, 226, 6, 6]
    assert sorted(r.svtype for r in full.records).count("BND") == 250
    # Every chromosome is in exactly one translocation.
    tra = [c for e in full.events if e.kind in ("TRA", "TRA_INV")
           for c in (e.chrom, e.mate)]
    assert sorted(tra) == list(range(24))


@pytest.mark.parametrize("seed", range(50))
def test_placement_never_fails_and_keeps_events_apart(seed):
    cfg = config()
    cat = galt.make_catalogue(cfg, 2**31 + 1000 * seed)
    m, bm = cfg["sv_margin_bp"], cfg["bnd_margin_bp"]
    for c, g in enumerate(cat.genome):
        spans = sorted(
            [(e.pos - m, e.pos + e.length + m) for e in cat.events
             if e.chrom == c and e.kind in galt.LOCAL]
            + [(p - bm, p + bm) for e in cat.events
               if e.kind in ("TRA", "TRA_INV")
               for cc, p in ((e.chrom, e.pos), (e.mate, e.mate_pos))
               if cc == c])
        assert spans[0][0] >= m and spans[-1][1] <= len(g) - m
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def _contexts(cat, r):
    """The (left, right) contexts of record ``r``'s alt junctions and the
    (chromosome, coordinate) of its ref junctions, from the genome."""
    rec = cat.records[r]
    e = cat.events[rec.event]
    p, L = e.pos, e.length
    g = cat.genome[e.chrom]
    rc = galt.revcomp
    if e.kind in ("DEL", "BND"):
        alt = [(g[p - K:p], g[p + L:p + L + K])]
        ref = [(e.chrom, p), (e.chrom, p + L)]
    elif e.kind == "INS":
        alt = [(g[p - K:p], e.ins_seq[:K]), (e.ins_seq[-K:], g[p:p + K])]
        ref = [(e.chrom, p)]
    elif e.kind == "INV":
        alt = [(g[p - K:p], rc(g[p + L - K:p + L])),
               (rc(g[p:p + K]), g[p + L:p + L + K])]
        ref = [(e.chrom, p), (e.chrom, p + L)]
    else:
        b, q = cat.genome[e.mate], e.mate_pos
        first = rec.chrom == e.chrom and rec.pos == p
        if e.kind == "TRA":
            alt = [(g[p - K:p], b[q:q + K]) if first
                   else (b[q - K:q], g[p:p + K])]
        else:
            alt = [(g[p - K:p], rc(b[q - K:q])) if first
                   else (rc(b[q:q + K]), g[p:p + K])]
        ref = [(e.chrom, p), (e.mate, q)]
    return alt, ref


def _same(ctx, want):
    """Equal contexts, in either orientation (an arm may be reversed)."""
    (l, r), (wl, wr) = ctx, want
    rc = galt.revcomp
    return (np.array_equal(l, wl) and np.array_equal(r, wr)) or (
        np.array_equal(l, rc(wr)) and np.array_equal(r, rc(wl)))


@pytest.mark.parametrize("seed", [1, 2**31 + 77])
def test_derivatives_hold_every_junction(seed):
    """Every carried allele's junction sits in the derivative haplotypes
    where ``junctions`` puts it: an alt junction's fusion, a ref junction's
    reference sequence on both sides."""
    cat = galt.make_catalogue(config(**SMALL), seed)
    seen = {0: 0, 1: 0}
    for hap, seqs in enumerate(cat.haplotypes()):
        for r, allele, slot, j, link in galt.junctions(cat, hap):
            s = seqs[slot]
            ctx = (s[j - K:j], s[j:j + K])
            alt, ref = _contexts(cat, r)
            if allele:
                assert link == -1
                assert any(_same(ctx, w) for w in alt), (hap, r)
            else:
                g = cat.genome[link]
                assert any(
                    c == link and _same(ctx, (g[x - K:x], g[x:x + K]))
                    for c, x in ref), (hap, r)
            seen[allele] += 1
        # The derivative haplotypes' lengths: the carried local changes.
        change = sum(e.change for e in cat.events if e.carried(hap))
        assert sum(map(len, seqs)) == cat.genome_bp + change
    assert seen[0] and seen[1]


def test_error_free_reads_are_their_fragments(tmp_path):
    cat, sample, fastq = make(5, tmp_path, sub_rate=0.0, ins_rate=0.0,
                              del_rate=0.0)
    seqs = fastq.split(b"\n")[1::4]
    haps = cat.haplotypes()
    assert len(set(sample.slot.tolist())) == len(cat.names)
    for i in range(sample.n_reads):
        s = haps[sample.hap[i]][sample.slot[i]]
        frag = s[sample.start[i]:sample.start[i] + sample.frag_len[i]]
        assert len(frag) == sample.frag_len[i]
        if sample.strand[i]:
            frag = galt.revcomp(frag)
        assert galt.ACGT[frag].tobytes() == seqs[i]


def test_truth_counts_by_brute_force(tmp_path):
    cat, sample, _ = make(21, tmp_path)
    want = np.zeros((cat.n_svs, 2), dtype=np.int64)
    rec_chrom = [r.chrom for r in cat.records]
    for hap in (0, 1):
        for r, allele, slot, j, link in galt.junctions(cat, hap):
            if link >= 0 and link != rec_chrom[r]:
                continue
            for i in np.flatnonzero((sample.hap == hap)
                                    & (sample.slot == slot)):
                s, e = sample.start[i], sample.start[i] + sample.frag_len[i]
                if j - s >= 100 and e - j >= 100:
                    want[r, allele] += 1
    assert np.array_equal(ralt.truth_counts(cat, sample, 100), want)
    assert want[[r.svtype == "BND" for r in cat.records]].sum() > 0


def test_port_takes_every_record(tmp_path):
    """The port's parser ignores no record of the written VCF, and its
    ``build_graph`` places every record's links."""
    from svjedi_tpu_torch.graph.build import build_graph
    from svjedi_tpu_torch.graph.svparse import parse_vcf_svs

    cat = galt.make_catalogue(config(), 2**31 + 5)
    cat.write_vcf(tmp_path / "c.vcf")
    chroms = cat.fasta_dict()
    parsed = parse_vcf_svs(tmp_path / "c.vcf",
                           {c: len(s) for c, s in chroms.items()})
    assert parsed.discarded == [] and len(parsed.svs) == cat.n_svs == 1000
    warnings = []
    build_graph(chroms, parsed, warnings=warnings)
    assert warnings == []
    # The reference's keys are the program's writer's.
    from svjedi_tpu_torch.genotype.vcf_writer import derive_record_key

    vcf = (tmp_path / "c.vcf").read_text()
    seen = {}
    assert [k for _, k in ralt._typed_keys(vcf)] == [
        derive_record_key(f[0], f[1], f[4], f[7], seen)[1]
        for f in ralt.vcf_records(vcf)]


@pytest.mark.parametrize("seed", [1, 2**31 + 3])
def test_control_is_not_correct(tmp_path, seed):
    cell = cells.load_cell(CELL)
    cell.config.update(SMALL)
    cell.mix.update(SMALL_MIX)
    g = cell.config["guarantees"]
    cat = cell.gen.make_catalogue(cell.config, seed)
    cat.write_vcf(tmp_path / "c.vcf")
    vcf = (tmp_path / "c.vcf").read_text()
    sample = cell.gen.make_sample(cat, cell.mix, seed, tmp_path / "s.fastq")
    got = calibrate.control_numbers(cell, cat, sample, vcf)
    assert got["ad_gap"] > cell.limits["ad_gap"]
    assert got["model_mismatch"] > cell.limits["model_mismatch"]
    # The halving is all the control breaks: INV and BND are not halved.
    assert got["ad_gap_INV"] == got["ad_gap_BND"] == 0.0

    ref = cell.reference
    truth = ref.truth_counts(cat, sample, g["d_over"])
    table = ref.reference_counts(vcf, truth)
    cols = ref.expected_columns(vcf, table, g["min_support"], g["err"])
    own = "\n".join("\t".join(f[:8] + ["GT:DP:AD:PL", c]) for f, c in
                    zip(ref.vcf_records(vcf), cols))
    assert ref.compare(vcf, own, table, cols, g["min_support"],
                       g["err"]) == {
        "ad_gap": 0.0, "model_mismatch": 0, "ad_gap_DEL": 0.0,
        "ad_gap_INS": 0.0, "ad_gap_INV": 0.0, "ad_gap_BND": 0.0}


def test_a_fault_in_one_type_is_not_diluted():
    """``ad_gap`` is the largest per-type gap: a fault in the BND records
    alone reads at its own size, not at its share of all records."""
    lines = [f"c\t{1000 * (i + 1)}\tv\tN\t<DEL>\t.\t.\tSVTYPE=DEL;END="
             f"{1000 * (i + 1) + 100}" for i in range(30)]
    lines.append("c\t99000\tb\tN\tN[c:99501[\t.\t.\tSVTYPE=BND")
    vcf = "#CHROM\n" + "\n".join(lines) + "\n"
    table = {k: [20, 10] for _, k in ralt._typed_keys(vcf)}
    cols = ralt.expected_columns(vcf, table, 3, 5e-05)
    bad = dict(table)
    bad["c:BND-99000[c:99501["] = [0, 0]
    job = "\n".join("\t".join(f[:8] + ["GT:DP:AD:PL", c]) for f, c in zip(
        ralt.vcf_records(vcf), ralt.expected_columns(vcf, bad, 3, 5e-05)))
    got = ralt.compare(vcf, job, bad, cols, 3, 5e-05)
    assert got["ad_gap"] == got["ad_gap_BND"] == 1.0
    assert got["ad_gap_DEL"] == 0.0 and got["model_mismatch"] == 0


def test_model_agrees_with_the_programs_writer_on_bnd_and_inv(tmp_path):
    """The reference's model and keys give the program's VCF column for BND
    records of every flavour the generator writes and for INV."""
    from svjedi_tpu_torch.genotype.vcf_writer import write_genotyped_vcf

    alts = ("N[c:{m}[", "N]c:{m}]", "[c:{m}[N")
    lines, table = [], {}
    for a in range(0, 25, 4):
        for b in range(0, 25, 3):
            pos = 1000 * (a * 40 + b + 1)
            alt = alts[(a + b) % 3].format(m=pos + 700)
            lines.append(f"c\t{pos}\tv\tN\t{alt}\t.\t.\tSVTYPE=BND")
            lines.append(f"c\t{pos + 5}\tv\tN\t<INV>\t.\t.\t"
                         f"SVTYPE=INV;END={pos + 105}")
    vcf = "#CHROM\n" + "\n".join(lines) + "\n"
    for i, (_, key) in enumerate(ralt._typed_keys(vcf)):
        table[key] = [i % 17, (3 * i) % 13]
    (tmp_path / "in.vcf").write_text(vcf)
    write_genotyped_vcf(tmp_path / "in.vcf", tmp_path / "out.vcf", table)
    got = [r[9] for r in ralt.vcf_records(
        (tmp_path / "out.vcf").read_text())]
    assert got == ralt.expected_columns(vcf, table, 3, 5e-05)
