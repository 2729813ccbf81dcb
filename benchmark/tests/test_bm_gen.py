"""The frozen generator: fixed by the seed, the same work for every seed,
the default configuration's inputs pinned byte for byte, and the
reference's counts from its origins."""

import hashlib

import numpy as np
import pytest

from benchmark import gen, reference

CFG = {"name": "t", "chrom": "chr1", "genome_bp": 60_000, "n_svs": 6,
       "sv_types": ["DEL", "INS", "INV"], "sv_min_len": 50,
       "sv_max_len": 600, "sv_margin_bp": 2500}
MIX = {"name": "m", "coverage": 5, "mean_len": 2000, "sd_len": 600,
       "min_len": 300, "sub_rate": 0.04, "ins_rate": 0.03, "del_rate": 0.03}


def make(seed, tmp_path):
    cat = gen.make_catalogue(CFG, seed)
    path = tmp_path / f"s{seed}.fastq"
    sample = gen.make_sample(cat, MIX, seed, path)
    return cat, sample, path.read_bytes()


def test_same_seed_same_inputs(tmp_path):
    seed = 2**31 + 12345  # past 32 signed bits
    a, sa, fa = make(seed, tmp_path)
    b, sb, fb = make(seed, tmp_path)
    assert fa == fb and np.array_equal(a.genome, b.genome)
    assert np.array_equal(a.pos, b.pos) and np.array_equal(sa.start, sb.start)
    c, sc, fc = make(seed + 1, tmp_path)
    assert fc != fa and not np.array_equal(c.genome, a.genome)


def test_every_seed_has_the_same_work(tmp_path):
    a, sa, _ = make(3, tmp_path)
    b, sb, _ = make(-4, tmp_path)
    assert sorted(a.length) == sorted(b.length)
    assert sorted(a.svtype) == sorted(b.svtype)
    assert sorted(a.genotype) == sorted(b.genotype)
    assert sorted(sa.frag_len) == sorted(sb.frag_len)
    assert abs(sa.n_bases - sb.n_bases) < 0.01 * sa.n_bases


def test_svs_apart_and_haplotypes_apply_them(tmp_path):
    cat, sample, fastq = make(9, tmp_path)
    gaps = cat.pos[1:] - (cat.pos[:-1] + cat.length[:-1])
    assert (gaps >= 2 * CFG["sv_margin_bp"]).all()
    for hap in (0, 1):
        h = cat.haplotype(hap)
        d = np.where(cat.svtype == "INS", cat.length,
                     np.where(cat.svtype == "DEL", -cat.length, 0))
        assert len(h) == len(cat.genome) + int(d[cat.carried(hap)].sum())
        # The shift maps each SV's pos: the base before it is unchanged.
        shift = cat.hap_shift(hap)
        for i in range(cat.n_svs):
            p = int(cat.pos[i])
            assert h[p - 1 + shift[i]] == cat.genome[p - 1]
    lines = fastq.split(b"\n")
    assert len(lines) == 4 * sample.n_reads + 1
    assert sum(len(s) for s in lines[1::4]) == sample.n_bases


def test_error_free_reads_are_their_fragments(tmp_path):
    mix = dict(MIX, sub_rate=0.0, ins_rate=0.0, del_rate=0.0)
    cat = gen.make_catalogue(CFG, 5)
    path = tmp_path / "clean.fastq"
    sample = gen.make_sample(cat, mix, 5, path)
    seqs = path.read_bytes().split(b"\n")[1::4]
    haps = (cat.haplotype(0), cat.haplotype(1))
    for i in range(sample.n_reads):
        frag = haps[sample.hap[i]][sample.start[i]:
                                   sample.start[i] + sample.frag_len[i]]
        if sample.strand[i]:
            frag = gen.revcomp(frag)
        assert gen.ACGT[frag].tobytes() == seqs[i]


def test_truth_counts_by_brute_force(tmp_path):
    cat, sample, _ = make(21, tmp_path)
    want = np.zeros((cat.n_svs, 2), dtype=np.int64)
    for hap in (0, 1):
        for sv, allele, j in gen.junctions(cat, hap):
            for r in np.flatnonzero(sample.hap == hap):
                s, e = sample.start[r], sample.start[r] + sample.frag_len[r]
                if j - s >= 100 and e - j >= 100:
                    want[sv, allele] += 1
    assert np.array_equal(reference.truth_counts(cat, sample, 100), want)


#: sha256 of the catalogue VCF and of the FASTQ that the tiny cell's
#: generator writes, taken with the generator as it was before
#: configurations could name their own; the default must not move them.
TINY_DIGESTS = {
    7: ("c5001c729f1922bf8e686fb1271ac9b12041b0364cbf814e590989c3410ee044",
        "5b0abd73ddb6ed55deb893ae9a4c81ba849563c06418593d8a7493b535c7aa75"),
    2**31 + 11: (
        "402d2d166e07877121798f5718d5ff5161bf745d7d23706be6350a654eec63c9",
        "1d17b704504d76e9cafd4a9841c974e892cdc7c42b14875b7f36fc54329e1cca"),
}


@pytest.mark.parametrize("seed", sorted(TINY_DIGESTS))
def test_default_generator_inputs_are_pinned(tiny_cell, tmp_path, seed):
    assert tiny_cell.gen is gen
    cat = tiny_cell.gen.make_catalogue(tiny_cell.config, seed)
    cat.write_vcf(tmp_path / "c.vcf")
    tiny_cell.gen.make_sample(cat, tiny_cell.mix, seed, tmp_path / "s.fastq")
    got = tuple(hashlib.sha256((tmp_path / f).read_bytes()).hexdigest()
                for f in ("c.vcf", "s.fastq"))
    assert got == TINY_DIGESTS[seed]
