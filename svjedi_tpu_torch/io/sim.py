# Copied verbatim from svjedi_tpu/io/sim.py.
"""Simulator: genomes, SV truth sets, and noisy long reads.

Self-contained test/bench data generation covering the BASELINE.md simulated
configs (single-chromosome DEL+INS sets up to whole-genome all-type sets with
long noisy reads). The golden end-to-end gate still runs on the reference's
bundled test-dir; this module exists so unit tests and benchmarks don't
depend on external data.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_BASES = "ACGT"


@dataclass
class SimSV:
    chrom: str
    pos: int  # 1-based VCF POS
    svtype: str  # DEL / INS / INV / BND
    length: int
    genotype: str  # "0/0", "0/1", "1/1"
    ins_seq: str = ""
    #: BND only: mate locus, ALT flavor, and the translocation event id
    #: (records of one reciprocal event share it and the genotype).
    mate_chrom: str = ""
    mate_pos: int = 0  # 1-based position inside the ALT string
    flavor: str = ""  # "t[p[", "t]p]", "]p]t", "[p[t"
    event: int = -1

    @property
    def end(self) -> int:
        if self.svtype in ("INS", "BND"):
            return self.pos + 1
        return self.pos + self.length

    @property
    def alt(self) -> str:
        if self.svtype != "BND":
            raise ValueError("alt only defined for BND")
        m = f"{self.mate_chrom}:{self.mate_pos}"
        return {
            "t[p[": f"N[{m}[",
            "t]p]": f"N]{m}]",
            "]p]t": f"]{m}]N",
            "[p[t": f"[{m}[N",
        }[self.flavor]


@dataclass
class Simulation:
    chroms: Dict[str, str]
    svs: List[SimSV]
    #: two haplotype sequence dicts
    haplotypes: Tuple[Dict[str, str], Dict[str, str]]


def random_genome(rng: np.random.Generator, chrom_lengths: Dict[str, int]) -> Dict[str, str]:
    # Vectorized byte mapping: the per-char Python join took ~100 ns/base
    # (minutes at chromosome scale).
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    return {
        name: lut[rng.integers(0, 4, size=length)].tobytes().decode()
        for name, length in chrom_lengths.items()
    }


def simulate_svs(
    rng: np.random.Generator,
    chroms: Dict[str, str],
    n_svs: int,
    sv_types: Sequence[str] = ("DEL", "INS", "INV"),
    min_len: int = 50,
    max_len: int = 600,
    min_separation: int = 2500,
) -> List[SimSV]:
    """Place non-overlapping SVs with random genotypes."""
    import bisect

    svs: List[SimSV] = []
    names = list(chroms)
    genotypes = ["0/0", "0/1", "1/1"]
    attempts = 0
    # Per-chrom non-overlapping spans kept sorted: the overlap test is a
    # bisect + two neighbor checks (the old full-list scan made 25k-SV
    # simulations take hours — O(n^2) in pure Python).
    occ_start: Dict[str, List[int]] = {c: [] for c in names}
    occ_end: Dict[str, List[int]] = {c: [] for c in names}
    while len(svs) < n_svs and attempts < n_svs * 50:
        attempts += 1
        chrom = names[int(rng.integers(len(names)))]
        clen = len(chroms[chrom])
        svtype = sv_types[int(rng.integers(len(sv_types)))]
        length = int(rng.integers(min_len, max_len + 1))
        pos = int(rng.integers(min_separation, max(min_separation + 1, clen - length - min_separation)))
        span = (pos - min_separation, pos + length + min_separation)
        ss, ee = occ_start[chrom], occ_end[chrom]
        i = bisect.bisect_left(ss, span[0])
        # Overlap iff the previous span ends at/after our start or the
        # next span starts at/before our end (closed-interval test, as
        # the old `not (span[1] < a or span[0] > b)` scan).
        if (i > 0 and ee[i - 1] >= span[0]) or (
            i < len(ss) and ss[i] <= span[1]
        ):
            continue
        ss.insert(i, span[0])
        ee.insert(i, span[1])
        ins_seq = ""
        if svtype == "INS":
            ins_seq = "".join(
                _BASES[i] for i in rng.integers(0, 4, size=length)
            )
        svs.append(
            SimSV(
                chrom=chrom,
                pos=pos,
                svtype=svtype,
                length=length,
                genotype=genotypes[int(rng.integers(3))],
                ins_seq=ins_seq,
            )
        )
    svs.sort(key=lambda s: (s.chrom, s.pos))
    return svs


def _rc(seq: str) -> str:
    return seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def simulate_translocations(
    rng: np.random.Generator,
    chroms: Dict[str, str],
    n_events: int,
    margin: int = 5000,
) -> List[SimSV]:
    """Reciprocal translocation events as VCF breakend record pairs.

    Each inter-chromosomal event joins (cA, pA) to (cB, pB) and emits the
    two junction records of the two derivative chromosomes, mirroring the
    reference test bundle's pairs (test-dir/test.vcf id35-id40):

    - non-inverted: ``cA pA N[cB:pB+1[``  (der1 = cA[:pA] ++ cB[pB:]) and
      ``cB pB N[cA:pA+1[``               (der2 = cB[:pB] ++ cA[pA:]);
    - inverted: ``cA pA N]cB:pB]``       (der1 = cA[:pA] ++ rc(cB[:pB]))
      and ``cA pA+1 [cB:pB+1[N``         (der2 = rc(cB[pB:]) ++ cA[pA:]).

    Odd leftover slots become intra-chromosomal single-junction events
    ``c p1 N[c:p2+1[`` (der = c[:p1] ++ c[p2:], the id24/id30 pattern).
    Every chromosome is used by at most one event (the derivative
    construction in :func:`apply_haplotype` replaces whole chromosomes).
    """
    genotypes = ["0/0", "0/1", "1/1"]
    names = [c for c in chroms if len(chroms[c]) >= 3 * margin]
    rng.shuffle(names)
    out: List[SimSV] = []
    ev = 0
    while ev < n_events and names:
        g = genotypes[int(rng.integers(3))]
        if len(names) >= 2 and rng.random() < 0.75:
            ca, cb = names.pop(), names.pop()
            pa = int(rng.integers(margin, len(chroms[ca]) - margin))
            pb = int(rng.integers(margin, len(chroms[cb]) - margin))
            if rng.random() < 0.5:
                out.append(SimSV(ca, pa, "BND", 0, g, mate_chrom=cb,
                                 mate_pos=pb + 1, flavor="t[p[", event=ev))
                out.append(SimSV(cb, pb, "BND", 0, g, mate_chrom=ca,
                                 mate_pos=pa + 1, flavor="t[p[", event=ev))
            else:
                out.append(SimSV(ca, pa, "BND", 0, g, mate_chrom=cb,
                                 mate_pos=pb, flavor="t]p]", event=ev))
                out.append(SimSV(ca, pa + 1, "BND", 0, g, mate_chrom=cb,
                                 mate_pos=pb + 1, flavor="[p[t", event=ev))
        else:
            c = names.pop()
            clen = len(chroms[c])
            p1 = int(rng.integers(margin, clen - 2 * margin))
            p2 = int(rng.integers(p1 + margin, clen - margin))
            out.append(SimSV(c, p1, "BND", 0, g, mate_chrom=c,
                             mate_pos=p2 + 1, flavor="t[p[", event=ev))
        ev += 1
    return out


def _apply_bnd_events(
    chroms: Dict[str, str], bnds: Sequence[SimSV], hap: int
) -> Dict[str, str]:
    """Replace event chromosomes with their derivatives for carriers."""
    out = dict(chroms)
    by_event: Dict[int, List[SimSV]] = {}
    for sv in bnds:
        by_event.setdefault(sv.event, []).append(sv)
    for recs in by_event.values():
        g = recs[0].genotype
        carried = g == "1/1" or (g == "0/1" and hap == 1)
        if not carried:
            continue
        a = recs[0]
        ca = chroms[a.chrom]
        if a.mate_chrom == a.chrom:  # intra: single junction
            out[a.chrom] = ca[: a.pos] + ca[a.mate_pos - 1 :]
        elif a.flavor == "t[p[":  # reciprocal, direct orientation
            b = recs[1]
            cb = chroms[b.chrom]
            out[a.chrom] = ca[: a.pos] + cb[a.mate_pos - 1 :]
            out[b.chrom] = cb[: b.pos] + ca[b.mate_pos - 1 :]
        else:  # inverted pair (t]p] + [p[t, both records on a.chrom)
            b = recs[1]
            cb = chroms[a.mate_chrom]
            out[a.chrom] = ca[: a.pos] + _rc(cb[: a.mate_pos])
            out[a.mate_chrom] = _rc(cb[b.mate_pos - 1 :]) + ca[b.pos - 1 :]
    return out


def apply_haplotype(
    chroms: Dict[str, str], svs: Sequence[SimSV], hap: int
) -> Dict[str, str]:
    """Apply the alt alleles carried by haplotype ``hap`` (0 or 1).

    BND (translocation) events replace whole chromosomes with derivatives;
    the generator guarantees BND chromosomes carry no point SVs, so the
    original coordinates stay valid.
    """
    bnds = [sv for sv in svs if sv.svtype == "BND"]
    svs = [sv for sv in svs if sv.svtype != "BND"]
    out = {}
    for chrom, seq in chroms.items():
        edits = []
        for sv in svs:
            if sv.chrom != chrom:
                continue
            carried = (
                sv.genotype == "1/1"
                or (sv.genotype == "0/1" and hap == 1)
            )
            if carried:
                edits.append(sv)
        # Single-pass piece assembly: edits are non-overlapping by
        # construction, so slice the untouched segments between them and
        # join once (the old descending-position splice copied the whole
        # chromosome per edit — terabytes of copying at 25k SVs).
        pieces = []
        cur = 0
        for sv in sorted(edits, key=lambda s: s.pos):
            pieces.append(seq[cur : sv.pos])
            if sv.svtype == "DEL":
                cur = sv.pos + sv.length
            elif sv.svtype == "INS":
                pieces.append(sv.ins_seq)
                cur = sv.pos
            elif sv.svtype == "INV":
                pieces.append(_rc(seq[sv.pos : sv.pos + sv.length]))
                cur = sv.pos + sv.length
        pieces.append(seq[cur:])
        out[chrom] = "".join(pieces)
    if bnds:
        out = _apply_bnd_events(out, bnds, hap)
    return out


def simulate(
    seed: int,
    chrom_lengths: Dict[str, int],
    n_svs: int,
    sv_types: Sequence[str] = ("DEL", "INS", "INV"),
    n_bnd_events: int = 0,
) -> Simulation:
    """Genome + SV truth set + haplotypes.

    With ``"BND" in sv_types`` (or explicit ``n_bnd_events``), reciprocal
    translocation events are placed first, each consuming its chromosomes
    whole; the remaining point-SV types go on untouched chromosomes only.
    """
    rng = np.random.default_rng(seed)
    chroms = random_genome(rng, chrom_lengths)
    bnds: List[SimSV] = []
    point_types = tuple(t for t in sv_types if t != "BND")
    if "BND" in sv_types and n_bnd_events == 0:
        n_bnd_events = max(1, n_svs // 8)
    if n_bnd_events:
        bnds = simulate_translocations(rng, chroms, n_bnd_events)
    used = {sv.chrom for sv in bnds} | {sv.mate_chrom for sv in bnds}
    free_chroms = {c: s for c, s in chroms.items() if c not in used}
    svs: List[SimSV] = []
    if point_types and free_chroms and n_svs > len(bnds):
        svs = simulate_svs(rng, free_chroms, n_svs - len(bnds), point_types)
    svs = sorted(svs + bnds, key=lambda s: (s.chrom, s.pos))
    haps = (apply_haplotype(chroms, svs, 0), apply_haplotype(chroms, svs, 1))
    return Simulation(chroms=chroms, svs=svs, haplotypes=haps)


def write_truth_vcf(sim: Simulation, path) -> None:
    with open(path, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n")
        fh.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description="Type of structural variant">\n')
        fh.write('##INFO=<ID=END,Number=1,Type=Integer,Description="End position">\n')
        fh.write('##INFO=<ID=SVLEN,Number=1,Type=Integer,Description="SV length">\n')
        fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tTRUTH\n")
        for i, sv in enumerate(sim.svs):
            if sv.svtype == "DEL":
                alt, svlen = "<DEL>", -sv.length
            elif sv.svtype == "INV":
                alt, svlen = "<INV>", 0
            elif sv.svtype == "BND":
                alt, svlen = sv.alt, 0
            else:
                alt, svlen = sv.ins_seq, sv.length
            fh.write(
                f"{sv.chrom}\t{sv.pos}\tsim{i}\tN\t{alt}\t.\t.\t"
                f"SVTYPE={sv.svtype};END={sv.end};SVLEN={svlen}\tGT\t{sv.genotype}\n"
            )


def iter_reads(
    rng: np.random.Generator,
    haplotypes: Tuple[Dict[str, str], Dict[str, str]],
    coverage: float,
    mean_len: int = 8000,
    sd_len: int = 3000,
    min_len: int = 300,
    sub_rate: float = 0.04,
    ins_rate: float = 0.03,
    del_rate: float = 0.03,
):
    """Yield noisy (name, sequence) reads uniformly over both haplotypes.

    Generator form so genome-scale benches can stream reads straight to a
    FASTQ on disk (``simulate_reads_fastq``) instead of holding 10s of GB
    of read strings resident; ``simulate_reads`` collects it for the
    in-memory callers. Identical sampling order either way (same rng
    consumption), so the two forms produce the same reads.
    """
    totals = [sum(len(s) for s in hap.values()) for hap in haplotypes]
    n_bases = int(coverage * sum(totals) / 2)
    generated = 0
    i = 0
    trans = np.frombuffer(b"ACGT", dtype=np.uint8)
    while generated < n_bases:
        hap_i = int(rng.integers(2))
        hap = haplotypes[hap_i]
        chrom = list(hap)[int(rng.integers(len(hap)))]
        seq = hap[chrom]
        length = int(np.clip(rng.normal(mean_len, sd_len), min_len, len(seq)))
        start = int(rng.integers(0, max(1, len(seq) - length + 1)))
        fragment = seq[start : start + length]
        codes = np.frombuffer(fragment.encode(), dtype=np.uint8)
        # Apply errors, vectorized: per input base emit 0-2 output bases
        # (deletion; optional inserted base; substituted or original base).
        r = rng.random(len(codes))
        shift = rng.integers(1, 4, size=len(codes))
        base_idx = np.searchsorted(trans, codes)
        deleted = r < del_rate
        inserted = (r >= del_rate) & (r < del_rate + ins_rate)
        substituted = (
            (r >= del_rate) & (r < del_rate + ins_rate + sub_rate)
        )
        kept = trans[
            np.where(substituted, (base_idx + shift) % 4, base_idx)
        ]
        n_out = (~deleted).astype(np.int64) + inserted
        ends = np.cumsum(n_out)
        total = int(ends[-1]) if len(ends) else 0
        out = np.empty(total, dtype=np.uint8)
        keep_pos = ends - 1  # kept/sub base goes last in its slot
        ins_pos = ends - n_out  # inserted base (if any) goes first
        sel = ~deleted
        out[keep_pos[sel]] = kept[sel]
        if inserted.any():
            out[ins_pos[inserted]] = trans[
                rng.integers(0, 4, size=int(inserted.sum()))
            ]
        read = out.tobytes().decode()
        if rng.random() < 0.5:
            read = read.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        yield f"sim_read_{i}_hap{hap_i}_{chrom}_{start}", read
        generated += len(read)
        i += 1


def simulate_reads(
    rng: np.random.Generator,
    haplotypes: Tuple[Dict[str, str], Dict[str, str]],
    coverage: float,
    **kw,
) -> Tuple[List[str], List[str]]:
    """Sample noisy reads; returns (names, sequences) as ASCII strings."""
    names, seqs = [], []
    for name, seq in iter_reads(rng, haplotypes, coverage, **kw):
        names.append(name)
        seqs.append(seq)
    return names, seqs


def simulate_reads_fastq(
    rng: np.random.Generator,
    haplotypes: Tuple[Dict[str, str], Dict[str, str]],
    coverage: float,
    path,
    **kw,
) -> Tuple[int, int]:
    """Stream simulated reads straight to a FASTQ file on disk.

    The genome-scale form: read strings never accumulate in memory, so a
    1 Gb x 12x simulation costs disk, not RSS. Returns (n_reads, n_bases).
    """
    n_reads = 0
    n_bases = 0
    with open(path, "w") as fh:
        for name, seq in iter_reads(rng, haplotypes, coverage, **kw):
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
            n_reads += 1
            n_bases += len(seq)
    return n_reads, n_bases


def write_fastq(path, names: List[str], seqs: List[str]) -> None:
    with open(path, "w") as fh:
        for name, seq in zip(names, seqs):
            fh.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
