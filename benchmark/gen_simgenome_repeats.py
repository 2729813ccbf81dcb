"""The repeat-rich catalogue's generator: the all-types catalogue
(``gen_simgenome_alltypes.py``) on a genome in which Alu-like, L1-like and
tandem-repeat copies make the human genome's shares of the sequence, with
mobile-element SVs.

:func:`make_catalogue` calls ``gen_simgenome_alltypes.make_catalogue`` with
the configuration's keys, so that the records' chromosomes, positions, types
and genotypes are that module's for the same keys and seed, and only the
sequence differs. Then, from streams of their own:

- the copies (:func:`repeat_copies`): per chromosome, each family's copies
  until their bases make the family's ``share`` of it, the last one cut to
  fit. Alu-like: the 282 bp consensus with a poly-A tail; L1-like:
  5'-truncated copies of the 6,000 bp consensus; tandem: arrays of one unit
  repeated. Each copy is diverged from its source at a rate drawn in the
  family's range (``mutate``: substitutions and 1-3 bp indels, edits per
  source base), and lies on a random strand. A chromosome's copies are laid
  out in a random order at sorted uniform gaps, so they never overlap one
  another and each family keeps its share; they overwrite whatever lies
  below them: flanks, deleted and inverted spans, and the sequence at BND
  breakpoints alike;
- the mobile-element SVs (:func:`mobile_elements`): ``ins_alu_share`` of
  the INS records, drawn by the seed, insert a fresh Alu-like copy (with
  its tail, on a random strand) and take its length; ``del_alu_share`` of
  the DEL records, those whose lengths lie nearest a full Alu's, delete a
  span overwritten by an Alu-like copy of exactly the DEL's length (the
  consensus 5'-truncated or given a longer tail, the tail taking up the
  indels' net change).

The consensus sequences are fixed by the configuration's name; every copy's
length, place, strand, divergence and mutations, and each tandem array's
unit, come from the seed. The catalogue carries its copies (``copies``, a
:class:`Copies`) and its mobile-element events (``mobile``: event index to
``(kind, divergence)``) for the tests.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from . import gen_simgenome_alltypes as galt
from .gen import _fixed_rng, _rng, revcomp

#: The families, in the order of their codes in :attr:`Copies.family`.
FAMILIES = ("alu", "l1", "tandem")
#: The code of base A (the poly-A tail).
A = 0

make_sample = galt.make_sample


@dataclass
class Copies:
    """The repeat copies laid over the genome, one row each, grouped by
    chromosome: where each lies (``chrom``, ``start``, ``length``), its
    family code, divergence and strand, and its bases before (``src``,
    forward strand) and after mutation (``seq``, as written), each
    concatenated with its offsets."""

    chrom: np.ndarray
    start: np.ndarray
    length: np.ndarray
    family: np.ndarray
    rate: np.ndarray
    strand: np.ndarray
    src: np.ndarray
    src_off: np.ndarray
    seq: np.ndarray
    seq_off: np.ndarray

    def source(self, i: int) -> np.ndarray:
        return self.src[self.src_off[i]:self.src_off[i + 1]]

    def bases(self, i: int) -> np.ndarray:
        return self.seq[self.seq_off[i]:self.seq_off[i + 1]]


def consensus(cfg: dict) -> Dict[str, np.ndarray]:
    """The Alu-like and L1-like consensus sequences, fixed by the
    configuration's name."""
    fixed = _fixed_rng(cfg["name"], 11)
    rep = cfg["repeats"]
    return {f: fixed.integers(0, 4, size=int(rep[f]["consensus_bp"]),
                              dtype=np.uint8) for f in ("alu", "l1")}


def _offsets(lengths: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)


def _local(lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row, position within the row) of every base of rows of
    ``lengths``."""
    row = np.repeat(np.arange(len(lengths)), lengths)
    return row, np.arange(len(row)) - _offsets(lengths)[:-1][row]


def mutate(rng, src: np.ndarray, lengths: np.ndarray, rate: np.ndarray,
           sub_share: float) -> Tuple[np.ndarray, np.ndarray]:
    """Each row of ``src`` (concatenated rows of ``lengths``) diverged at
    its ``rate`` of edits per source base: at each base a substitution with
    probability ``sub_share * rate``, else an indel of 1-3 bp (insertion
    after the base or deletion from it, one or the other, within the row)
    with probability ``(1 - sub_share) / 2 * rate``, 2 bp on average.
    Returns the mutated rows and their lengths."""
    n = len(src)
    row, pos = _local(lengths)
    r = rate[row]
    u = rng.random(n)
    sub = u < sub_share * r
    out = src.copy()
    out[sub] = (src[sub] + rng.integers(1, 4, size=int(sub.sum()),
                                        dtype=np.uint8)) % 4
    event = ~sub & (u < (sub_share + (1 - sub_share) / 2) * r)
    at = np.flatnonzero(event)
    size = rng.integers(1, 4, size=len(at))
    ins = rng.random(len(at)) < 0.5
    # Deleted bases: [at, at + size) cut at the row's end.
    d, end = at[~ins], np.minimum(at[~ins] + size[~ins],
                                  at[~ins] - pos[at[~ins]]
                                  + lengths[row[at[~ins]]])
    cover = np.zeros(n + 1, dtype=np.int64)
    np.add.at(cover, d, 1)
    np.add.at(cover, end, -1)
    count = (np.cumsum(cover[:-1]) == 0).astype(np.int64)
    # An insertion after a kept base: the base, then ``size`` new ones.
    keep_ins = ins & (count[at] > 0)
    np.add.at(count, at[keep_ins], size[keep_ins])
    seq = np.repeat(out, count)
    first = np.repeat(_offsets(count)[:-1], count)
    new = np.arange(len(seq)) != first
    seq[new] = rng.integers(0, 4, size=int(new.sum()), dtype=np.uint8)
    return seq, np.bincount(row, weights=count,
                            minlength=len(lengths)).astype(np.int64)


def orient(seq: np.ndarray, lengths: np.ndarray,
           strand: np.ndarray) -> np.ndarray:
    """The rows of ``seq`` whose ``strand`` is 1 reverse-complemented."""
    row, pos = _local(lengths)
    flip = strand[row].astype(bool)
    src = np.where(flip, _offsets(lengths)[:-1][row] + lengths[row] - 1 - pos,
                   np.arange(len(seq)))
    out = seq[src]
    out[flip] = 3 - out[flip]
    return out


def _fill(lengths: np.ndarray, target: int, least: int) -> np.ndarray:
    """The first of ``lengths`` that reach ``target`` bases, the last cut
    so that they make it exactly (dropped if the cut leaves fewer than
    ``least``)."""
    total = np.cumsum(lengths)
    k = int(np.searchsorted(total, target, side="left"))
    if k >= len(lengths):
        raise ValueError("too few lengths drawn for the target")
    out = lengths[:k + 1].copy()
    out[k] -= int(total[k]) - target
    return out if out[k] >= least else out[:k]


def _draws(rng, fam: dict, family: str, n: int) -> np.ndarray:
    """``n`` source lengths of a family's copies."""
    if family == "alu":
        lo, hi = fam["tail_bp"]
        return int(fam["consensus_bp"]) + rng.integers(lo, hi + 1, size=n)
    if family == "l1":
        full, least = int(fam["consensus_bp"]), int(fam["min_bp"])
        p = float(fam["full_length_share"])
        # Truncated copies: ``least`` plus an exponential, its mean such
        # that all copies average ``mean_bp``.
        scale = (float(fam["mean_bp"]) - p * full) / (1 - p) - least
        cut = np.minimum(least + rng.exponential(scale, size=n),
                         full - 1).astype(np.int64)
        return np.where(rng.random(n) < p, full, cut)
    lo, hi = fam["array_bp"]
    return rng.integers(lo, hi + 1, size=n)


def _mean(fam: dict, family: str) -> float:
    """The mean of a family's source lengths."""
    if family == "alu":
        return int(fam["consensus_bp"]) + sum(fam["tail_bp"]) / 2
    if family == "l1":
        return float(fam["mean_bp"])
    return sum(fam["array_bp"]) / 2


def repeat_copies(cfg: dict, seed: int, lens: np.ndarray) -> Copies:
    """The copies for chromosomes of ``lens``: drawn, mutated, oriented and
    placed (see the module's docstring)."""
    rep = cfg["repeats"]
    cons = consensus(cfg)
    rng = _rng(seed, 11)
    chrom, family, length = [], [], []
    for c, L in enumerate(lens.tolist()):
        for f, name in enumerate(FAMILIES):
            fam = rep[name]
            target = int(round(float(fam["share"]) * L))
            if target <= 0:
                continue
            n = int(target / _mean(fam, name) * 1.5) + 16
            drawn = _fill(_draws(rng, fam, name, n), target, 20)
            chrom.append(np.full(len(drawn), c))
            family.append(np.full(len(drawn), f))
            length.append(drawn)
    chrom, family, length = (np.concatenate(x).astype(np.int64)
                             for x in (chrom, family, length))
    n = len(length)
    lo = np.array([rep[f]["divergence"][0] for f in FAMILIES])
    hi = np.array([rep[f]["divergence"][1] for f in FAMILIES])
    rate = lo[family] + rng.random(n) * (hi - lo)[family]
    strand = rng.integers(0, 2, size=n).astype(np.int8)

    # Sources: an Alu is its consensus then A; an L1 the last ``length``
    # bases of its consensus; a tandem array its unit, log-uniform in
    # ``unit_bp``, repeated.
    row, pos = _local(length)
    fam = family[row]
    src = np.full(len(row), A, dtype=np.uint8)
    alu = cons["alu"]
    on = (fam == 0) & (pos < len(alu))
    src[on] = alu[pos[on]]
    l1 = cons["l1"]
    on = fam == 1
    src[on] = l1[len(l1) - length[row[on]] + pos[on]]
    ulo, uhi = rep["tandem"]["unit_bp"]
    unit_len = np.minimum(np.exp(rng.uniform(np.log(ulo), np.log(uhi + 1),
                                             size=n)).astype(np.int64), uhi)
    unit_off = _offsets(np.where(family == 2, unit_len, 0))
    units = rng.integers(0, 4, size=int(unit_off[-1]), dtype=np.uint8)
    on = fam == 2
    src[on] = units[unit_off[row[on]] + pos[on] % unit_len[row[on]]]

    seq, new_len = mutate(rng, src, length, rate,
                          float(rep["substitution_share"]))
    seq = orient(seq, new_len, strand)

    # Places: per chromosome, the copies in a random order at sorted
    # uniform gaps.
    start = np.empty(n, dtype=np.int64)
    for c, L in enumerate(lens.tolist()):
        mine = np.flatnonzero(chrom == c)
        mine = mine[rng.permutation(len(mine))]
        free = L - int(new_len[mine].sum())
        if free < 0:
            raise ValueError(f"chromosome {c}: the copies do not fit")
        cuts = np.sort(rng.integers(0, free + 1, size=len(mine)))
        start[mine] = cuts + _offsets(new_len[mine])[:-1]
    return Copies(chrom=chrom, start=start, length=new_len, family=family,
                  rate=rate, strand=strand, src=src, src_off=_offsets(length),
                  seq=seq, seq_off=_offsets(new_len))


def overlay(genome: List[np.ndarray], copies: Copies) -> List[np.ndarray]:
    """``genome`` with every copy written over it (new arrays)."""
    out = [g.copy() for g in genome]
    row, pos = _local(copies.length)
    for c, g in enumerate(out):
        on = copies.chrom[row] == c
        g[copies.start[row[on]] + pos[on]] = copies.seq[on]
    return out


def alu_copy(rng, cons: np.ndarray, body: int, tail: int, rate: float,
             sub_share: float, strand: int) -> np.ndarray:
    """One Alu-like copy: the consensus's last ``body`` bases, a poly-A
    tail of ``tail``, diverged at ``rate``, on ``strand``."""
    src = np.concatenate([cons[len(cons) - body:],
                          np.full(tail, A, dtype=np.uint8)])
    seq, _ = mutate(rng, src, np.array([len(src)]), np.array([rate]),
                    sub_share)
    return revcomp(seq) if strand else seq


def mobile_elements(cfg: dict, seed: int, events: List[galt.Event],
                    genome: List[np.ndarray]):
    """The events with the mobile-element INS and DEL set, and genome's
    deleted Alus written (in place). Returns (events, {event index:
    (kind, divergence)})."""
    me, rep = cfg["mobile_elements"], cfg["repeats"]
    cons = consensus(cfg)["alu"]
    full = len(cons)
    tlo, thi = rep["alu"]["tail_bp"]
    dlo, dhi = me["divergence"]
    sub_share = float(rep["substitution_share"])
    rng = _rng(seed, 13)
    events = list(events)
    mobile: Dict[int, Tuple[str, float]] = {}
    ins = [i for i, e in enumerate(events) if e.kind == "INS"]
    for i in sorted(rng.permutation(ins)[:int(len(ins)
                                               * me["ins_alu_share"])]):
        rate = float(rng.uniform(dlo, dhi))
        seq = alu_copy(rng, cons, full, int(rng.integers(tlo, thi + 1)),
                       rate, sub_share, int(rng.integers(0, 2)))
        events[i] = dataclasses.replace(events[i], length=len(seq),
                                        ins_seq=seq)
        mobile[i] = ("INS", rate)
    # The DELs nearest a full Alu's length (the middle of its tails), ties
    # by event order.
    dels = [i for i, e in enumerate(events) if e.kind == "DEL"]
    mid = full + (tlo + thi) // 2
    near = sorted(dels, key=lambda i: (abs(events[i].length - mid), i))
    for i in sorted(near[:int(len(dels) * me["del_alu_share"])]):
        e = events[i]
        L = e.length
        rate = float(rng.uniform(dlo, dhi))
        body = min(full, L - tlo)
        seq = alu_copy(rng, cons, body, L - body, rate, sub_share, 0)
        # Exactly L bases: the 5' end cut, or the tail made longer.
        seq = seq[len(seq) - L:] if len(seq) >= L else np.concatenate(
            [seq, np.full(L - len(seq), A, dtype=np.uint8)])
        if rng.integers(0, 2):
            seq = revcomp(seq)
        genome[e.chrom][e.pos:e.pos + L] = seq
        mobile[i] = ("DEL", rate)
    return events, mobile


def make_catalogue(cfg: dict, seed: int) -> galt.Catalogue:
    """The configuration's catalogue for ``seed``."""
    base = galt.make_catalogue(cfg, seed)
    lens = np.array([len(g) for g in base.genome], dtype=np.int64)
    copies = repeat_copies(cfg, seed, lens)
    genome = overlay(base.genome, copies)
    events, mobile = mobile_elements(cfg, seed, base.events, genome)
    cat = galt.assemble(base.names, genome, events)
    cat.copies, cat.mobile = copies, mobile
    return cat
