"""The all-types catalogue's generator: a genome of several chromosomes with
DEL, INS, INV and BND records, and one sample's reads drawn from the two
haplotypes' derivative chromosomes, made from ``--seed``.

BND records come in two kinds (the breakend flavours and derivatives of
``svjedi_tpu_torch/io/sim.py:simulate_translocations``):

- intra-chromosomal single junctions ``c p1 N[c:p2+1[``: the derivative is
  ``c[:p1] ++ c[p2:]``;
- reciprocal translocations between two chromosomes ``cA`` and ``cB``,
  each chromosome in at most one: direct, ``cA pA N[cB:pB+1[`` and
  ``cB pB N[cA:pA+1[`` (``cA[:pA] ++ cB[pB:]`` and ``cB[:pB] ++ cA[pA:]``);
  inverted, ``cA pA N]cB:pB]`` and ``cA pA+1 [cB:pB+1[N``
  (``cA[:pA] ++ rc(cB[:pB])`` and ``rc(cB[pB:]) ++ cA[pA:]``). The two
  records of an event share its genotype.

Coordinates are those of ``gen.py``: an event's 0-based ``pos`` is the
first base after its left junction and its VCF POS. A haplotype applies the
local events it carries (DEL, INS, INV, intra-chromosomal BND) chromosome
by chromosome, then splits the edited chromosomes at the translocations'
breakpoints and joins their arms. Genotype 0/1 is carried by haplotype 1.

As in ``gen.py``, the multisets of event types, lengths, spans and
genotypes and of read lengths come from streams fixed by the configuration
and the mix alone; the seed draws the genome, the insertions, which
chromosomes pair, the events' order and places, and the reads' haplotypes,
chromosomes, starts, strands and errors. Places are laid out, never
retried: each event goes to a chromosome drawn in proportion to the room it
has left (at first its length), then each chromosome's events are spread
over it by random gaps, so placement cannot fail while the padded events
fit in the genome.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .gen import (ACGT, BLOCK_BASES, GEN_THREADS, _block_reads, _fixed_rng,
                  _rng, revcomp)

#: Event kinds: the local ones, then the two kinds of translocation.
LOCAL = ("DEL", "INS", "INV", "BND")
DIRECT, INVERTED = "TRA", "TRA_INV"


@dataclass
class Event:
    kind: str  # one of LOCAL (BND: intra-chromosomal), DIRECT or INVERTED
    chrom: int  # chromosome index (a translocation: cA)
    pos: int = 0  # 0-based first base after the left junction (pA)
    length: int = 0  # DEL/INS/INV length, intra-BND span p2 - p1
    genotype: int = 0  # 0 for 0/0, 1 for 0/1, 2 for 1/1
    ins_seq: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint8))
    mate: int = -1  # a translocation's cB
    mate_pos: int = 0  # pB

    def carried(self, hap: int) -> bool:
        return self.genotype == 2 or (self.genotype == 1 and hap == 1)

    @property
    def change(self) -> int:
        """Bases the event adds to its chromosome where carried."""
        return {"DEL": -self.length, "INS": self.length,
                "BND": -self.length}.get(self.kind, 0)


@dataclass
class Record:
    """One VCF record of an event."""

    event: int
    chrom: int
    pos: int  # VCF POS
    svtype: str  # DEL / INS / INV / BND
    alt: str
    info: str


@dataclass
class Catalogue:
    names: List[str]
    genome: List[np.ndarray]  # per chromosome, uint8 codes 0..3
    events: List[Event]
    records: List[Record]  # in VCF order

    @property
    def genome_bp(self) -> int:
        return int(sum(len(g) for g in self.genome))

    @property
    def n_svs(self) -> int:
        return len(self.records)

    def fasta_dict(self) -> Dict[str, str]:
        return {n: ACGT[g].tobytes().decode()
                for n, g in zip(self.names, self.genome)}

    def write_vcf(self, path) -> None:
        """The catalogue as a sites VCF (no sample column)."""
        with open(path, "w") as fh:
            fh.write("##fileformat=VCFv4.2\n")
            for n, g in zip(self.names, self.genome):
                fh.write(f"##contig=<ID={n},length={len(g)}>\n")
            fh.write('##INFO=<ID=SVTYPE,Number=1,Type=String,Description='
                     '"Type of structural variant">\n')
            fh.write('##INFO=<ID=END,Number=1,Type=Integer,Description='
                     '"End position">\n')
            fh.write('##INFO=<ID=SVLEN,Number=1,Type=Integer,Description='
                     '"SV length">\n')
            fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
            for i, r in enumerate(self.records):
                fh.write(f"{self.names[r.chrom]}\t{r.pos}\tsv{i}\tN\t{r.alt}"
                         f"\t.\t.\t{r.info}\n")

    # -- haplotypes ---------------------------------------------------------

    def edited(self, hap: int) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Per chromosome, the sequence with the carried local events
        applied, and the sorted (pos, cumulative change after it) of those
        events for :meth:`shift`."""
        seqs, shifts = [], []
        for c, g in enumerate(self.genome):
            pieces, cur, marks, total = [], 0, [], 0
            for e in sorted((e for e in self.events
                             if e.chrom == c and e.kind in LOCAL
                             and e.carried(hap)), key=lambda e: e.pos):
                p, L = e.pos, e.length
                pieces.append(g[cur:p])
                if e.kind == "INS":
                    pieces.append(e.ins_seq)
                    cur = p
                elif e.kind == "INV":
                    pieces.append(revcomp(g[p:p + L]))
                    cur = p + L
                else:  # DEL, intra-BND
                    cur = p + L
                total += e.change
                marks.append((p, total))
            pieces.append(g[cur:])
            seqs.append(np.concatenate(pieces))
            shifts.append(np.array(marks, dtype=np.int64).reshape(-1, 2))
        return seqs, shifts

    @staticmethod
    def shift(marks: np.ndarray, x: int) -> int:
        """Edited minus reference coordinate at reference ``x`` (the carried
        events with pos < x)."""
        k = int(np.searchsorted(marks[:, 0], x, side="left"))
        return int(marks[k - 1, 1]) if k else 0

    def derivative(self, hap: int):
        """The haplotype's sequences, one slot per chromosome (a carried
        translocation's first derivative in cA's slot, its second in cB's),
        and ``place(c, x)``: the (slot, coordinate) of edited coordinate
        ``x`` of chromosome ``c`` as a junction (the first base after it)."""
        seqs, shifts = self.edited(hap)
        out = list(seqs)
        moves: Dict[int, Tuple] = {}
        for e in self.events:
            if e.kind not in (DIRECT, INVERTED) or not e.carried(hap):
                continue
            A, B = e.chrom, e.mate
            a = e.pos + self.shift(shifts[A], e.pos)
            b = e.mate_pos + self.shift(shifts[B], e.mate_pos)
            sa, sb = seqs[A], seqs[B]
            lb = len(sb)
            if e.kind == DIRECT:
                out[A] = np.concatenate([sa[:a], sb[b:]])
                out[B] = np.concatenate([sb[:b], sa[a:]])
                moves[A] = lambda x, A=A, B=B, a=a, b=b: (
                    (A, x) if x < a else (B, b + x - a))
                moves[B] = lambda x, A=A, B=B, a=a, b=b: (
                    (B, x) if x < b else (A, a + x - b))
            else:
                out[A] = np.concatenate([sa[:a], revcomp(sb[:b])])
                out[B] = np.concatenate([revcomp(sb[b:]), sa[a:]])
                moves[A] = lambda x, A=A, B=B, a=a, b=b, lb=lb: (
                    (A, x) if x < a else (B, lb - b + x - a))
                moves[B] = lambda x, A=A, B=B, a=a, b=b, lb=lb: (
                    (A, a + b - x) if x < b else (B, lb - x))

        def place(c: int, x: int) -> Tuple[int, int]:
            return moves[c](x) if c in moves else (c, x)

        return out, shifts, place

    def haplotypes(self) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        return tuple(self.derivative(h)[0] for h in (0, 1))


def junctions(cat: Catalogue, hap: int) -> List[Tuple[int, int, int, int,
                                                      int]]:
    """(record, allele, slot, coordinate of the first base after the
    junction, chromosome of the reference link or -1) for every junction of
    the allele that ``hap`` carries, on its derivative sequences:

    - DEL ref at pos and pos + L, alt at pos; INS ref at pos, alt at pos and
      pos + L; INV either allele at pos and pos + L; an intra-chromosomal
      BND ref at p1 and p2, alt at p1 (its one fusion);
    - a translocation's records: ref at both breakpoints, pA on cA and pB
      on cB (each with its chromosome: which of them a record's count may
      take is the reference's rule); alt at the record's own fusion.

    Alt junctions carry -1: the fusion is the record's own link."""
    _, shifts, place = cat.derivative(hap)
    by_event: Dict[int, List[int]] = {}
    for i, r in enumerate(cat.records):
        by_event.setdefault(r.event, []).append(i)
    out = []
    for ei, e in enumerate(cat.events):
        recs = by_event[ei]
        a = int(e.carried(hap))
        if e.kind in LOCAL:
            c = e.chrom
            p = e.pos + cat.shift(shifts[c], e.pos)
            L = e.length
            if e.kind == "INV":
                js = (p, p + L)
            elif e.kind == "INS":
                js = (p, p + L) if a else (p,)
            else:  # DEL and intra-BND: two ref junctions, one fusion
                js = (p,) if a else (p, p + L)
            link = -1 if a else c
            out += [(recs[0], a, *place(c, j), link) for j in js]
            continue
        A, B = e.chrom, e.mate
        if not a:
            for c, x in ((A, e.pos), (B, e.mate_pos)):
                j = x + cat.shift(shifts[c], x)
                out += [(r, 0, *place(c, j), c) for r in recs]
            continue
        a_ = e.pos + cat.shift(shifts[A], e.pos)
        b_ = e.mate_pos + cat.shift(shifts[B], e.mate_pos)
        # The first record (at pA on cA) is the fusion that ends cA's left
        # arm, in cA's slot; the other is where the second derivative's
        # arms meet, in cB's.
        first, second = sorted(recs, key=lambda i: (
            cat.records[i].chrom, cat.records[i].pos) != (A, e.pos))
        out.append((first, 1, A, a_, -1))
        lb = len(cat.genome[B])
        j2 = b_ if e.kind == DIRECT else lb + cat.shift(shifts[B], lb) - b_
        out.append((second, 1, B, j2, -1))
    return out


# -- the catalogue ----------------------------------------------------------


def _layout(rng, room: np.ndarray, padded: np.ndarray) -> np.ndarray:
    """Each item's chromosome: drawn in proportion to the room each has left
    among those where the item fits (items in the given order)."""
    room = room.astype(np.float64).copy()
    out = np.empty(len(padded), dtype=np.int64)
    for k, need in enumerate(padded.tolist()):
        fit = np.where(room >= need, room, 0.0)
        open_ = np.flatnonzero(fit)
        if not len(open_):
            raise ValueError("the padded events do not fit in the genome")
        cum = np.cumsum(fit)
        c = int(np.searchsorted(cum, rng.random() * cum[-1], side="right"))
        c = min(c, int(open_[-1]))  # a draw rounded up to the total
        out[k] = c
        room[c] -= need
    return out


def make_catalogue(cfg: dict, seed: int) -> Catalogue:
    """The configuration's catalogue for ``seed``."""
    names = list(cfg["chroms"])
    lens = np.array([int(cfg["chroms"][n]) for n in names], dtype=np.int64)
    if "genome_bp" in cfg and int(cfg["genome_bp"]) != int(lens.sum()):
        raise ValueError(f"{cfg['name']}: genome_bp {cfg['genome_bp']} is "
                         f"not the chromosomes' sum {int(lens.sum())}")
    n = int(cfg["n_svs"])
    types = list(cfg["sv_types"])
    share = n // len(types)
    n_direct = int(cfg["translocations_direct"])
    n_inv = int(cfg["translocations_inverted"])
    n_intra = share - 2 * (n_direct + n_inv)
    if share * len(types) != n or n_intra < 0 \
            or 2 * (n_direct + n_inv) > len(names):
        raise ValueError(f"{cfg['name']}: {n} records do not split into "
                         f"{types} with {n_direct} + {n_inv} translocations")
    lo, hi = int(cfg["sv_min_len"]), int(cfg["sv_max_len"])
    margin, bnd_margin = int(cfg["sv_margin_bp"]), int(cfg["bnd_margin_bp"])
    span_lo, span_hi = (int(cfg["bnd_intra_min_span"]),
                        int(cfg["bnd_intra_max_span"]))

    # The multisets, fixed by the configuration's name.
    fixed = _fixed_rng(cfg["name"], 1)
    kinds = [t for t in ("DEL", "INS", "INV") if t in types for _ in
             range(share)] + ["BND"] * n_intra
    lengths = np.concatenate([
        fixed.integers(lo, hi + 1, size=len(kinds) - n_intra),
        fixed.integers(span_lo, span_hi + 1, size=n_intra)]).astype(np.int64)
    groups = [np.flatnonzero(np.array(kinds) == t) for t in LOCAL]
    genos = np.zeros(len(kinds), dtype=np.int64)
    for g in groups:
        genos[g] = np.arange(len(g)) % 3
    tra_genos = np.arange(n_direct + n_inv, dtype=np.int64) % 3

    rng = _rng(seed, 1)
    genome = [rng.integers(0, 4, size=int(L), dtype=np.uint8) for L in lens]
    # Which of each kind gets which length and genotype.
    for g in groups:
        lengths[g] = lengths[g][rng.permutation(len(g))]
        genos[g] = genos[g][rng.permutation(len(g))]
    tra_genos = tra_genos[rng.permutation(len(tra_genos))]
    pairs = rng.permutation(len(names))[:2 * (n_direct + n_inv)].reshape(-1, 2)

    # Room: each chromosome keeps ``margin`` clear at both ends and its
    # translocation breakpoint, if any, padded by ``bnd_margin``.
    in_tra = np.zeros(len(names), dtype=bool)
    in_tra[pairs.ravel()] = True
    room = lens - 2 * margin - np.where(in_tra, 2 * bnd_margin, 0)
    order = rng.permutation(len(kinds))
    padded = lengths + 2 * margin
    chrom = np.empty(len(kinds), dtype=np.int64)
    chrom[order] = _layout(rng, room, padded[order])

    events: List[Event] = [
        Event(kind=kinds[i], chrom=int(chrom[i]), length=int(lengths[i]),
              genotype=int(genos[i]),
              ins_seq=(rng.integers(0, 4, size=int(lengths[i]), dtype=np.uint8)
                       if kinds[i] == "INS" else np.zeros(0, np.uint8)))
        for i in range(len(kinds))]
    bkpt = np.zeros(len(names), dtype=np.int64)  # translocation pos per chrom
    for c in range(len(names)):
        # The chromosome's items in a random order, the free room split at
        # sorted uniform points; a translocation breakpoint is an item of
        # length 0 padded by ``bnd_margin``.
        items = [(i, int(padded[i]), margin) for i in
                 order[np.isin(order, np.flatnonzero(chrom == c))]]
        if in_tra[c]:
            items.insert(int(rng.integers(0, len(items) + 1)),
                         (-1, 2 * bnd_margin, bnd_margin))
        free = int(lens[c]) - 2 * margin - sum(p for _, p, _ in items)
        cuts = np.sort(rng.integers(0, free + 1, size=len(items)))
        start = margin
        for (i, p, pad), cut in zip(items, cuts.tolist()):
            if i < 0:
                bkpt[c] = start + cut + pad
            else:
                events[i].pos = start + cut + pad
            start += p
    for t, (A, B) in enumerate(pairs.tolist()):
        events.append(Event(kind=DIRECT if t < n_direct else INVERTED,
                            chrom=A, pos=int(bkpt[A]),
                            genotype=int(tra_genos[t]), mate=B,
                            mate_pos=int(bkpt[B])))
    return assemble(names, genome, events)


def assemble(names: List[str], genome: List[np.ndarray],
             events: List[Event]) -> Catalogue:
    """The catalogue of ``events`` on ``genome``: their records in VCF
    order (by chromosome, then POS)."""
    records: List[Record] = []
    for ei, e in enumerate(events):
        p, L = e.pos, e.length
        if e.kind == "DEL":
            records.append(Record(ei, e.chrom, p, "DEL", "<DEL>",
                                  f"SVTYPE=DEL;END={p + L};SVLEN={-L}"))
        elif e.kind == "INS":
            records.append(Record(ei, e.chrom, p, "INS",
                                  ACGT[e.ins_seq].tobytes().decode(),
                                  f"SVTYPE=INS;END={p + 1};SVLEN={L}"))
        elif e.kind == "INV":
            records.append(Record(ei, e.chrom, p, "INV", "<INV>",
                                  f"SVTYPE=INV;END={p + L};SVLEN={L}"))
        elif e.kind == "BND":
            c = names[e.chrom]
            records.append(Record(ei, e.chrom, p, "BND",
                                  f"N[{c}:{p + L + 1}[", "SVTYPE=BND"))
        else:
            A, B, pa, pb = names[e.chrom], names[e.mate], p, e.mate_pos
            if e.kind == DIRECT:
                records += [Record(ei, e.chrom, pa, "BND",
                                   f"N[{B}:{pb + 1}[", "SVTYPE=BND"),
                            Record(ei, e.mate, pb, "BND",
                                   f"N[{A}:{pa + 1}[", "SVTYPE=BND")]
            else:
                records += [Record(ei, e.chrom, pa, "BND",
                                   f"N]{B}:{pb}]", "SVTYPE=BND"),
                            Record(ei, e.chrom, pa + 1, "BND",
                                   f"[{B}:{pb + 1}[N", "SVTYPE=BND")]
    records.sort(key=lambda r: (r.chrom, r.pos))
    return Catalogue(names=names, genome=genome, events=events,
                     records=records)


# -- the sample -------------------------------------------------------------


@dataclass
class Sample:
    """Each read's origin: haplotype, slot (derivative sequence), start and
    fragment length on it, and strand (1: reverse-complemented); its bases
    are in the FASTQ only."""

    hap: np.ndarray
    slot: np.ndarray
    start: np.ndarray
    frag_len: np.ndarray
    strand: np.ndarray
    n_bases: int

    @property
    def n_reads(self) -> int:
        return len(self.hap)


def read_lengths(mix: dict, genome_bp: int) -> np.ndarray:
    """The mix's read lengths, clipped to ``[min_len, max_len]``: fixed by
    the mix's name, drawn until they cover ``coverage`` x the genome."""
    rng = _fixed_rng(mix["name"], 2, genome_bp)
    target = float(mix["coverage"]) * genome_bp
    out, total = [], 0
    while total < target:
        L = np.clip(rng.normal(mix["mean_len"], mix["sd_len"], 4096),
                    mix["min_len"], mix["max_len"]).astype(np.int64)
        c = total + np.cumsum(L)
        k = int(np.searchsorted(c, target)) + 1
        out.append(L[:k])
        total = int(c[min(k, len(c)) - 1])
    return np.concatenate(out)


def make_sample(cat: Catalogue, mix: dict, seed: int, fastq_path) -> Sample:
    """Write the mix's sample of ``cat`` for ``seed`` to ``fastq_path``:
    each read from a haplotype, a slot drawn in proportion to its length on
    that haplotype, and a start on it."""
    haps = cat.haplotypes()
    slot_len = np.array([[len(s) for s in h] for h in haps], dtype=np.int64)
    base = np.concatenate([[0], np.cumsum(slot_len.ravel())[:-1]]).reshape(
        slot_len.shape)
    hapcat = np.concatenate(haps[0] + haps[1])
    lengths = read_lengths(mix, cat.genome_bp)
    rng = _rng(seed, 2)
    n = len(lengths)
    flen = lengths[rng.permutation(n)]
    hap = rng.integers(0, 2, size=n)
    u = rng.random(n)
    cum = np.cumsum(slot_len, axis=1)
    slot = np.empty(n, dtype=np.int64)
    for h in (0, 1):
        on = hap == h
        slot[on] = np.searchsorted(cum[h], u[on] * cum[h, -1], side="right")
    slot = np.minimum(slot, slot_len.shape[1] - 1)
    length = slot_len[hap, slot]
    flen = np.minimum(flen, length)
    start = (rng.random(n) * (length - flen + 1)).astype(np.int64)
    strand = rng.integers(0, 2, size=n)
    origin = base[hap, slot] + start
    zero = np.zeros(n, dtype=np.int64)
    qual = b"I" * int(flen.max() * 2 + 16)
    cum_len = np.cumsum(flen)
    bounds = np.unique(np.concatenate([
        [0], np.searchsorted(cum_len, np.arange(
            1, int(cum_len[-1]) // BLOCK_BASES + 1) * BLOCK_BASES), [n]]))

    def block(i):
        a, b = int(bounds[i]), int(bounds[i + 1])
        seq, off = _block_reads(_rng(seed, 3, i), hapcat, 0, zero[a:b],
                                origin[a:b], flen[a:b], strand[a:b], mix)
        raw = seq.tobytes()
        parts = []
        for j in range(b - a):
            o, e = int(off[j]), int(off[j + 1])
            parts += [b"@r%d\n" % (a + j), raw[o:e], b"\n+\n", qual[:e - o],
                      b"\n"]
        return b"".join(parts), len(raw)

    n_bases = 0
    with open(fastq_path, "wb") as fh, \
            ThreadPoolExecutor(max_workers=GEN_THREADS) as pool:
        for text, nb in pool.map(block, range(len(bounds) - 1)):
            fh.write(text)
            n_bases += nb
    return Sample(hap=hap, slot=slot, start=start, frag_len=flen,
                  strand=strand, n_bases=n_bases)
