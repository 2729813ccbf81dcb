"""The repeat-rich configuration's generator (``gen_simgenome_repeats.py``)
with the all-types reference it reuses: each family's share and
divergence, the mobile-element SVs, the same inputs for the same seed, the
all-types records unchanged, and a reference that counts by origin, never
by sequence."""

import json

import numpy as np
import pytest

from conftest import ROOT

from benchmark import gen_simgenome_alltypes as galt
from benchmark import gen_simgenome_repeats as grep
from benchmark import reference_simgenome_alltypes as ralt
from benchmark.gen import revcomp

#: Six small chromosomes and 24 records, as the all-types tests cut them.
SMALL = {"chroms": {f"c{i}": 36_000 + 4_000 * i for i in range(6)},
         "genome_bp": 276_000, "n_svs": 24, "translocations_direct": 1,
         "translocations_inverted": 1}
SMALL_MIX = {"coverage": 3, "mean_len": 3000, "sd_len": 1000,
             "max_len": 8000}
SEEDS = (2**31 + 4321, 17, -3)


def config(**over):
    cfg = json.loads(
        (ROOT / "benchmark/configs/simgenome-repeats.json").read_text())
    cfg["name"] = "simgenome-repeats"
    cfg.update(over)
    return cfg


def mix():
    m = json.loads((ROOT / "benchmark/mixes/ont30x.json").read_text())
    m["name"] = "ont30x"
    m.update(SMALL_MIX)
    return m


@pytest.fixture(scope="module", params=SEEDS[:2])
def full(request):
    """The configuration's own layout (24 chromosomes, 10.3 Mb)."""
    return config(), grep.make_catalogue(config(), request.param)


def edits(a: np.ndarray, b: np.ndarray) -> int:
    """Levenshtein distance, one row of the table at a time."""
    prev = np.arange(len(b) + 1)
    for i, x in enumerate(a, 1):
        diag = prev[:-1] + (b != x)
        up = prev[1:] + 1
        t = np.minimum(diag, up)
        cur = np.empty_like(prev)
        cur[0] = i
        # cur[j] = min(t[j - 1], cur[j - 1] + 1), as a running minimum.
        cur[1:] = np.minimum.accumulate(
            np.r_[i, t] - np.arange(len(b) + 1))[1:] + np.arange(1, len(b) + 1)
        prev = cur
    return int(prev[-1])


def slack(rate: float, n: int) -> float:
    """Room for the spread of a copy's edits per base around its rate: four
    standard deviations of a count whose indels add to its variance."""
    return 4 * np.sqrt(1.5 * max(rate, 0.01) / n) + 0.01


def test_edits_helper():
    a = np.array([0, 1, 2, 3, 0, 1], dtype=np.uint8)
    assert edits(a, a) == 0
    assert edits(a, a[1:]) == 1
    assert edits(a, np.array([0, 1, 3, 3, 0, 1, 2], dtype=np.uint8)) == 2


def test_each_family_makes_its_share(full):
    cfg, cat = full
    c, rep = cat.copies, cfg["repeats"]
    lens = np.array([len(g) for g in cat.genome])
    for f, name in enumerate(grep.FAMILIES):
        share = rep[name]["share"]
        on = c.family == f
        assert abs(c.length[on].sum() / cat.genome_bp - share) < 0.01, name
        per = np.bincount(c.chrom[on], weights=c.length[on],
                          minlength=len(lens)) / lens
        assert np.all(np.abs(per - share) < 0.01), name
    # The copies never overlap, and the genome holds each one's bases but
    # where a deleted Alu was written over it.
    label = [np.full(len(g), -1) for g in cat.genome]
    row, pos = grep._local(c.length)
    for ch in range(len(lens)):
        on = c.chrom[row] == ch
        at = c.start[row[on]] + pos[on]
        assert np.all(label[ch][at] == -1)
        label[ch][at] = row[on]
        differ = cat.genome[ch][at] != c.seq[on]
        dels = [e for i, e in enumerate(cat.events)
                if cat.mobile.get(i, ("",))[0] == "DEL" and e.chrom == ch]
        inside = np.zeros(len(lens[ch:ch + 1]) and lens[ch], dtype=bool)
        for e in dels:
            inside[e.pos:e.pos + e.length] = True
        assert not np.any(differ & ~inside[at])
    # About 3,600 Alu-like and 1,900 L1-like copies, as `reduced` says.
    assert 3300 < (c.family == 0).sum() < 3900
    assert 1700 < (c.family == 1).sum() < 2200


def test_copies_diverge_within_their_ranges(full):
    cfg, cat = full
    c, rep = cat.copies, cfg["repeats"]
    rng = np.random.default_rng(0)
    for f, name in enumerate(grep.FAMILIES):
        lo, hi = rep[name]["divergence"]
        on = np.flatnonzero(c.family == f)
        assert lo <= c.rate[on].min() and c.rate[on].max() <= hi, name
        short = on[(c.length[on] >= 250) & (c.length[on] <= 900)]
        got = []
        for i in rng.choice(short, 12, replace=False):
            seq = c.bases(i)
            seq = revcomp(seq) if c.strand[i] else seq
            src = c.source(i)
            got.append((edits(seq, src) / len(src), c.rate[i], len(src)))
        for d, rate, n in got:
            # Edits per source base at the copy's rate; a tandem array's
            # shifted units can only align with fewer edits.
            assert d <= rate + slack(rate, n), (name, d, rate)
            if name != "tandem":
                assert d >= rate - slack(rate, n), (name, d, rate)


def test_l1_copies_are_5prime_truncated(full):
    cfg, cat = full
    c, fam = cat.copies, cfg["repeats"]["l1"]
    cons = grep.consensus(cfg)["l1"]
    on = np.flatnonzero(c.family == 1)
    for i in on[:50]:
        src = c.source(i)
        assert np.array_equal(src, cons[len(cons) - len(src):])
    src_len = np.diff(c.src_off)[on]
    assert abs(src_len.mean() - fam["mean_bp"]) < 0.1 * fam["mean_bp"]
    full_share = (src_len == fam["consensus_bp"]).mean()
    assert abs(full_share - fam["full_length_share"]) < 0.02


def test_mobile_element_svs(full):
    cfg, cat = full
    me, alu = cfg["mobile_elements"], cfg["repeats"]["alu"]
    cons = grep.consensus(cfg)["alu"]
    kinds = {k: [i for i, (t, _) in cat.mobile.items() if t == k]
             for k in ("INS", "DEL")}
    n_ins = sum(e.kind == "INS" for e in cat.events)
    n_del = sum(e.kind == "DEL" for e in cat.events)
    assert len(kinds["INS"]) == int(n_ins * me["ins_alu_share"]) == 125
    assert len(kinds["DEL"]) == int(n_del * me["del_alu_share"]) == 62
    lo, hi = me["divergence"]
    tlo, thi = alu["tail_bp"]
    full_bp = alu["consensus_bp"]
    for i in kinds["INS"]:
        e, rate = cat.events[i], cat.mobile[i][1]
        assert lo <= rate <= hi
        assert e.length == len(e.ins_seq)
        assert full_bp + tlo - 10 <= e.length <= full_bp + thi + 10
        src = np.r_[cons, np.zeros(max(e.length - full_bp, 0), np.uint8)]
        d = min(edits(e.ins_seq, src), edits(revcomp(e.ins_seq), src))
        assert d <= (rate + slack(rate, e.length)) * e.length
    lens = sorted(cat.events[i].length for i in kinds["DEL"])
    others = [e.length for i, e in enumerate(cat.events)
              if e.kind == "DEL" and i not in cat.mobile]
    mid = full_bp + (tlo + thi) // 2
    assert max(abs(L - mid) for L in lens) <= min(abs(L - mid)
                                                  for L in others)
    for i in kinds["DEL"][:20]:
        e, rate = cat.events[i], cat.mobile[i][1]
        assert lo <= rate <= hi
        span = cat.genome[e.chrom][e.pos:e.pos + e.length]
        body = min(full_bp, e.length - tlo)
        src = np.r_[cons[full_bp - body:], np.zeros(e.length - body,
                                                    np.uint8)]
        d = min(edits(span, src), edits(revcomp(span), src))
        assert d <= (rate + slack(rate, e.length)) * e.length
    # The INS records' ALT is the inserted Alu.
    by_pos = {(r.chrom, r.pos): r for r in cat.records if r.svtype == "INS"}
    for i in kinds["INS"][:10]:
        e = cat.events[i]
        assert by_pos[(e.chrom, e.pos)].alt == galt.ACGT[
            e.ins_seq].tobytes().decode()


def test_records_are_the_alltypes_records():
    """Only the sequence differs from ``gen_simgenome_alltypes`` for the
    same keys and seed (and the mobile-element INS lengths)."""
    for seed in SEEDS:
        cat = grep.make_catalogue(config(**SMALL), seed)
        base = galt.make_catalogue(config(**SMALL), seed)
        assert [(r.chrom, r.pos, r.svtype) for r in cat.records] == \
            [(r.chrom, r.pos, r.svtype) for r in base.records]
        assert [(e.kind, e.chrom, e.pos, e.genotype, e.mate, e.mate_pos)
                for e in cat.events] == \
            [(e.kind, e.chrom, e.pos, e.genotype, e.mate, e.mate_pos)
             for e in base.events]
        for i, (e, b) in enumerate(zip(cat.events, base.events)):
            if i not in cat.mobile or e.kind != "INS":
                assert e.length == b.length
        assert any(not np.array_equal(a, b)
                   for a, b in zip(cat.genome, base.genome))


def test_same_seed_same_inputs(tmp_path):
    seed = SEEDS[0]
    out = []
    for k in range(2):
        cat = grep.make_catalogue(config(**SMALL), seed)
        cat.write_vcf(tmp_path / f"{k}.vcf")
        grep.make_sample(cat, mix(), seed, tmp_path / f"{k}.fastq")
        out.append((cat.fasta_dict(), (tmp_path / f"{k}.vcf").read_bytes(),
                    (tmp_path / f"{k}.fastq").read_bytes()))
    assert out[0] == out[1]
    other = grep.make_catalogue(config(**SMALL), seed + 1)
    assert other.fasta_dict() != out[0][0]


def test_reference_counts_by_origin_not_by_sequence():
    """Hand-built reads that start inside repeat copies give the same truth
    counts over the repeat-rich genome as over random sequence under the
    same records."""
    cat = grep.make_catalogue(config(**SMALL), SEEDS[1])
    rng = np.random.default_rng(1)
    plain = galt.assemble(cat.names, [
        rng.integers(0, 4, len(g), dtype=np.uint8) for g in cat.genome],
        cat.events)
    c = cat.copies
    pick = rng.choice(len(c.start), 400)
    n = len(pick)
    haps = cat.haplotypes()
    hap = rng.integers(0, 2, n)
    slot = c.chrom[pick]
    frag = np.full(n, 6000)
    room = np.array([len(haps[h][s]) for h, s in zip(hap, slot)])
    start = np.minimum(c.start[pick], room - frag)
    sample = galt.Sample(hap=hap, slot=slot, start=start, frag_len=frag,
                         strand=rng.integers(0, 2, n),
                         n_bases=int(frag.sum()))
    got = ralt.truth_counts(cat, sample, 100)
    assert got.sum() > 0
    assert np.array_equal(got, ralt.truth_counts(plain, sample, 100))
