"""The benchmark's frozen generator: a catalogue (genome + SV VCF) and one
sample's reads, made from ``--seed``.

Frozen from the semantics of ``svjedi_tpu_torch/io/sim.py`` (genome,
``simulate_svs``, ``apply_haplotype``, ``iter_reads``, ``write_truth_vcf``)
and vectorised over reads; it does not match that file byte for byte and is
never imported from the program. Two rules keep every seed's work alike:
the multisets of SV types, lengths and genotypes and of read lengths are
drawn from streams fixed by the configuration and the mix alone; the seed
draws the genome, the insertions, the SVs' order and places, and the reads'
haplotypes, starts, strands and errors.

Coordinates: an SV's VCF POS is 1-based; its 0-based ``pos`` is the first
base after its left junction (the graph's node boundary). A DEL removes
``[pos, pos + L)``, an INS puts its sequence before ``pos``, an INV reverse-
complements ``[pos, pos + L)``. Genotype 0/1 is carried by haplotype 1.
"""

from __future__ import annotations

import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
#: Read bases per block of reads made at once (bounds set-up memory).
BLOCK_BASES = 4_000_000
#: Threads making blocks.
GEN_THREADS = 4


def _rng(seed: int, *stream) -> np.random.Generator:
    """An independent stream for (seed, stream...); any integer seed."""
    return np.random.default_rng(
        np.random.SeedSequence([abs(int(seed)), int(seed < 0), *stream]))


def _fixed_rng(name: str, *stream) -> np.random.Generator:
    """A stream fixed by a configuration's or a mix's name alone."""
    return np.random.default_rng(
        np.random.SeedSequence([zlib.crc32(name.encode()), *stream]))


def revcomp(codes: np.ndarray) -> np.ndarray:
    return (3 - codes[::-1]).astype(np.uint8)


@dataclass
class Catalogue:
    chrom: str
    genome: np.ndarray  # uint8 codes 0..3
    svtype: np.ndarray  # object array of "DEL"/"INS"/"INV", sorted by pos
    pos: np.ndarray  # int64, 0-based first base after the left junction
    length: np.ndarray  # int64
    genotype: np.ndarray  # int64: 0 for 0/0, 1 for 0/1, 2 for 1/1
    ins_seq: List[np.ndarray]  # per SV; empty unless INS

    @property
    def n_svs(self) -> int:
        return len(self.pos)

    def carried(self, hap: int) -> np.ndarray:
        """Whether haplotype ``hap`` carries each SV's alt allele."""
        return (self.genotype == 2) | ((self.genotype == 1) & (hap == 1))

    def haplotype(self, hap: int) -> np.ndarray:
        pieces, cur = [], 0
        g = self.genome
        for i in np.flatnonzero(self.carried(hap)):
            p, L, t = int(self.pos[i]), int(self.length[i]), self.svtype[i]
            pieces.append(g[cur:p])
            if t == "DEL":
                cur = p + L
            elif t == "INS":
                pieces.append(self.ins_seq[i])
                cur = p
            else:
                pieces.append(revcomp(g[p:p + L]))
                cur = p + L
        pieces.append(g[cur:])
        return np.concatenate(pieces)

    def hap_shift(self, hap: int) -> np.ndarray:
        """Per SV, haplotype minus reference coordinate at its ``pos``."""
        d = np.where(self.svtype == "INS", self.length,
                     np.where(self.svtype == "DEL", -self.length, 0))
        d = np.where(self.carried(hap), d, 0)
        return np.concatenate([[0], np.cumsum(d)[:-1]]).astype(np.int64)

    def fasta_dict(self):
        return {self.chrom: ACGT[self.genome].tobytes().decode()}

    def write_vcf(self, path) -> None:
        """The catalogue as a sites VCF (no sample column)."""
        with open(path, "w") as fh:
            fh.write("##fileformat=VCFv4.2\n")
            fh.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description='
                     '"Type of structural variant">\n')
            fh.write('##INFO=<ID=END,Number=1,Type=Integer,Description='
                     '"End position">\n')
            fh.write('##INFO=<ID=SVLEN,Number=1,Type=Integer,Description='
                     '"SV length">\n')
            fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            for i in range(self.n_svs):
                t, p, L = self.svtype[i], int(self.pos[i]), int(self.length[i])
                if t == "DEL":
                    alt, end, svlen = "<DEL>", p + L, -L
                elif t == "INV":
                    alt, end, svlen = "<INV>", p + L, 0
                else:
                    alt = ACGT[self.ins_seq[i]].tobytes().decode()
                    end, svlen = p + 1, L
                fh.write(f"{self.chrom}\t{p}\tsv{i}\tN\t{alt}\t.\t.\t"
                         f"SVTYPE={t};END={end};SVLEN={svlen}\n")


def make_catalogue(cfg: dict, seed: int) -> Catalogue:
    """The configuration's catalogue for ``seed``."""
    n, G = int(cfg["n_svs"]), int(cfg["genome_bp"])
    lo, hi = int(cfg["sv_min_len"]), int(cfg["sv_max_len"])
    margin = int(cfg["sv_margin_bp"])
    types = list(cfg["sv_types"])
    fixed = _fixed_rng(cfg["name"], 1)
    kinds = np.array([types[i % len(types)] for i in range(n)], dtype=object)
    lengths = fixed.integers(lo, hi + 1, size=n).astype(np.int64)
    genos = np.arange(n, dtype=np.int64) % 3
    rng = _rng(seed, 1)
    genome = rng.integers(0, 4, size=G, dtype=np.uint8)
    order = rng.permutation(n)
    kinds, lengths = kinds[order], lengths[order]
    genos = genos[rng.permutation(n)]
    # Places: each SV's span padded by ``margin`` on both sides stays clear
    # of the next one's and of the chromosome's ends; the free room is
    # split at n sorted uniform points.
    free = G - 2 * margin - int((lengths + 2 * margin).sum())
    if free <= 0:
        raise ValueError(f"{cfg['name']}: {n} SVs do not fit in {G} bp")
    cuts = np.sort(rng.integers(0, free, size=n))
    pos = 2 * margin + cuts + np.concatenate(
        [[0], np.cumsum(lengths + 2 * margin)[:-1]])
    ins = [rng.integers(0, 4, size=int(L), dtype=np.uint8) if k == "INS"
           else np.zeros(0, np.uint8) for k, L in zip(kinds, lengths)]
    return Catalogue(chrom=cfg["chrom"], genome=genome, svtype=kinds,
                     pos=pos.astype(np.int64), length=lengths,
                     genotype=genos, ins_seq=ins)


@dataclass
class Sample:
    """Each read's origin: haplotype, start and fragment length on it, and
    strand (1: reverse-complemented); its bases are in the FASTQ only."""

    hap: np.ndarray
    start: np.ndarray
    frag_len: np.ndarray
    strand: np.ndarray
    n_bases: int  # read bases written (after errors)

    @property
    def n_reads(self) -> int:
        return len(self.hap)


def read_lengths(mix: dict, genome_bp: int) -> np.ndarray:
    """The mix's read lengths for a genome: fixed by the mix's name, drawn
    until they cover ``coverage`` x the genome."""
    rng = _fixed_rng(mix["name"], 2, genome_bp)
    target = float(mix["coverage"]) * genome_bp
    out, total = [], 0
    while total < target:
        L = np.clip(rng.normal(mix["mean_len"], mix["sd_len"], 4096),
                    mix["min_len"], None).astype(np.int64)
        c = total + np.cumsum(L)
        k = int(np.searchsorted(c, target)) + 1
        out.append(L[:k])
        total = int(c[min(k, len(c)) - 1])
    return np.concatenate(out)


def _block_reads(rng, hapcat, hap_off, hap, start, flen, strand, mix):
    """Reads of one block: fragments of the two haplotypes (concatenated in
    ``hapcat``, haplotype 1 at ``hap_off``), errors, strands; concatenated
    ASCII bases and per-read output offsets."""
    seg = np.concatenate([[0], np.cumsum(flen)]).astype(np.int64)
    tot = int(seg[-1])
    rel = np.arange(tot, dtype=np.int64) - np.repeat(seg[:-1], flen)
    rev = np.repeat(strand == 1, flen)
    # A reverse read reads its fragment backwards, complemented.
    np.subtract(np.repeat(flen - 1, flen), rel, out=rel, where=rev)
    rel += np.repeat(start + hap * hap_off, flen)
    base = hapcat[rel]
    np.subtract(3, base, out=base, where=rev)
    # Errors per base, in units of 1e-4: deletion, insertion before the
    # base, substitution, in that order of the draw.
    d, i_, s = (int(round(mix[k] * 10000))
                for k in ("del_rate", "ins_rate", "sub_rate"))
    r = rng.integers(0, 10000, tot, dtype=np.uint16)
    deleted = r < d
    inserted = (r >= d) & (r < d + i_)
    sub = np.flatnonzero((r >= d + i_) & (r < d + i_ + s))
    base[sub] = (base[sub] + rng.integers(1, 4, len(sub), dtype=np.uint8)) % 4
    n_out = 1 - deleted.astype(np.int64) + inserted
    ends = np.cumsum(n_out)
    out = np.empty(int(ends[-1]) if tot else 0, dtype=np.uint8)
    keep = ~deleted
    out[ends[keep] - 1] = base[keep]
    out[(ends - n_out)[inserted]] = rng.integers(
        0, 4, int(inserted.sum()), dtype=np.uint8)
    offsets = np.concatenate([[0], ends[seg[1:] - 1]])
    return ACGT[out], offsets


def make_sample(cat: Catalogue, mix: dict, seed: int, fastq_path) -> Sample:
    """Write the mix's sample of ``cat`` for ``seed`` to ``fastq_path``."""
    haps = (cat.haplotype(0), cat.haplotype(1))
    hapcat = np.concatenate(haps)
    lengths = read_lengths(mix, len(cat.genome))
    rng = _rng(seed, 2)
    n = len(lengths)
    flen = lengths[rng.permutation(n)]
    hap = rng.integers(0, 2, size=n)
    hap_len = np.where(hap == 0, len(haps[0]), len(haps[1]))
    flen = np.minimum(flen, hap_len)
    start = (rng.random(n) * (hap_len - flen + 1)).astype(np.int64)
    strand = rng.integers(0, 2, size=n)
    qual = b"I" * int(flen.max() * 2 + 16)
    cum = np.cumsum(flen)
    bounds = np.unique(np.concatenate([
        [0], np.searchsorted(cum, np.arange(1, int(cum[-1]) // BLOCK_BASES
                                            + 1) * BLOCK_BASES), [n]]))

    def block(i):
        a, b = int(bounds[i]), int(bounds[i + 1])
        seq, off = _block_reads(_rng(seed, 3, i), hapcat, len(haps[0]),
                                hap[a:b], start[a:b], flen[a:b],
                                strand[a:b], mix)
        raw = seq.tobytes()
        parts = []
        for j in range(b - a):
            o, e = int(off[j]), int(off[j + 1])
            parts += [b"@r%d\n" % (a + j), raw[o:e], b"\n+\n", qual[:e - o],
                      b"\n"]
        return b"".join(parts), len(raw)

    # Blocks are independent streams of the seed, made on a few threads
    # (numpy releases the interpreter lock) and written in order.
    n_bases = 0
    with open(fastq_path, "wb") as fh, \
            ThreadPoolExecutor(max_workers=GEN_THREADS) as pool:
        for text, nb in pool.map(block, range(len(bounds) - 1)):
            fh.write(text)
            n_bases += nb
    return Sample(hap=hap, start=start, frag_len=flen, strand=strand,
                  n_bases=n_bases)


def junctions(cat: Catalogue, hap: int) -> List[Tuple[int, int, int]]:
    """(SV index, allele, haplotype coordinate of the first base after the
    junction) for every junction of the allele that ``hap`` carries: DEL
    ref at pos and pos + L, alt at pos; INS ref at pos, alt at pos and
    pos + L; INV either allele at pos and pos + L."""
    shift = cat.hap_shift(hap)
    alt = cat.carried(hap)
    out = []
    for i in range(cat.n_svs):
        p, L, t = int(cat.pos[i]) + int(shift[i]), int(cat.length[i]), \
            cat.svtype[i]
        a = int(alt[i])
        if t == "DEL":
            js = (p,) if a else (p, p + L)
        elif t == "INS":
            js = (p, p + L) if a else (p,)
        else:
            js = (p, p + L)
        out += [(i, a, j) for j in js]
    return out
