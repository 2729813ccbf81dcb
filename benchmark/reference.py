"""The plain reference that decides ``correct``, and the comparison.

Nothing here imports the program. The reference works from the inputs the
benchmark made (the catalogue and each read's origin) and from the
configuration's stated guarantees:

- Counting: a read supports an allele at a junction when it comes from a
  haplotype that carries that allele and covers at least ``d_over`` bases on
  each side of the junction; each (read, junction) counts once. This is what
  an aligner that places every read at its origin counts.
- Genotyping: SVJedi-graph's binomial model: the count of the allele with
  two breakpoints (DEL ref, INS alt) is halved to one decimal, GT is the
  unique most likely genotype under error ``err`` (else ./.), ./. below
  ``min_support``, PL = int(-10 (L_g + log10 C(n, k))) on rounded counts.

Two numbers are compared per job (:func:`compare`):

- ``ad_gap``: sum over records of |AD - AD_ref| (both alleles) over the sum
  of AD_ref: the job's allele depths against the reference's counts. It
  covers seeding, the DP, winner election and counting.
- ``model_mismatch``: records whose sample column (GT:DP:AD:PL), or whose
  site columns, differ from the reference's model applied to the job's own
  raw counts, plus records missing or added. Exact: its limit is 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: Genotype names of the model's three likelihoods.
GT_NAMES = ("0/0", "0/1", "1/1")


def truth_counts(cat, sample, d_over: int) -> np.ndarray:
    """(n_svs, 2) raw [ref, alt] counts of reads crossing each allele's
    junctions by ``d_over`` bases on both sides."""
    from .gen import junctions

    counts = np.zeros((cat.n_svs, 2), dtype=np.int64)
    ends = sample.start + sample.frag_len
    for hap in (0, 1):
        on = np.flatnonzero(sample.hap == hap)
        order = np.argsort(sample.start[on], kind="stable")
        s = sample.start[on][order]
        e = ends[on][order]
        longest = int(sample.frag_len.max()) if len(sample.frag_len) else 0
        for sv, allele, j in junctions(cat, hap):
            lo = np.searchsorted(s, j + d_over - longest, side="left")
            hi = np.searchsorted(s, j - d_over, side="right")
            counts[sv, allele] += int((e[lo:hi] >= j + d_over).sum())
    return counts


def _key(chrom: str, pos: str, svtype: str, info: str,
         ins_seen: Dict[str, int]) -> str:
    """The count table's key of a VCF record (SVJedi-graph's sv ids)."""
    fields = dict(kv.split("=", 1) for kv in info.split(";") if "=" in kv)
    if svtype == "INS":
        ins_seen[pos] = ins_seen.get(pos, 0) + 1
        return f"{chrom}:INS-{pos}-{ins_seen[pos]}"
    if svtype in ("DEL", "INV"):
        return f"{chrom}:{svtype}-{pos}-{fields['END']}"
    raise ValueError(f"the reference genotypes DEL, INS and INV only, not "
                     f"{svtype}")


def genotype(raw: Sequence[int], svtype: str, min_support: int, err: float,
             halve: bool = True) -> str:
    """The sample column GT:DP:AD:PL of raw [ref, alt] counts. ``halve``
    False is the control's broken guarantee."""
    c = [raw[0], raw[1]]
    two_bkpt = {"DEL": 0, "INS": 1}.get(svtype)
    if halve and two_bkpt is not None and c[two_bkpt] > 0:
        c[two_bkpt] = round(c[two_bkpt] / 2, 1)
    l_ok, l_err, l_half = math.log10(1 - err), math.log10(err), math.log10(0.5)
    liks = [c[0] * l_ok + c[1] * l_err,
            (c[0] + c[1]) * l_half,
            c[1] * l_ok + c[0] * l_err]
    best = max(liks)
    top = [g for g in range(3) if liks[g] == best]
    gt = GT_NAMES[top[0]] if len(top) == 1 else "./."
    if not c[0] + c[1] >= min_support:
        gt = "./."
    r0, r1 = int(round(c[0])), int(round(c[1]))
    comb = math.log10(math.comb(r0 + r1, r0))
    pl = ",".join(str(int(-10 * (lik + comb))) for lik in liks)
    return f"{gt}:{round(c[0] + c[1], 3)}:{c[0]},{c[1]}:{pl}"


def vcf_records(text: str) -> List[List[str]]:
    return [line.split("\t") for line in text.splitlines()
            if line and not line.startswith("#")]


def _typed_keys(catalogue_vcf: str) -> List[Tuple[str, str]]:
    """(SVTYPE, count-table key) of each catalogue record, in order."""
    out, ins_seen = [], {}
    for f in vcf_records(catalogue_vcf):
        svtype = dict(kv.split("=", 1) for kv in f[7].split(";")
                      if "=" in kv)["SVTYPE"]
        out.append((svtype, _key(f[0], f[1], svtype, f[7], ins_seen)))
    return out


def expected_columns(catalogue_vcf: str, raw: Dict[str, Sequence[int]],
                     min_support: int, err: float,
                     halve: bool = True) -> List[str]:
    """Per catalogue record, the sample column the model gives ``raw``
    (a count table keyed as SVJedi-graph keys it)."""
    return [genotype(raw[key], svtype, min_support, err, halve)
            if key in raw else "./.:0:0,0:.,.,."
            for svtype, key in _typed_keys(catalogue_vcf)]


def reference_counts(catalogue_vcf: str, truth: np.ndarray) -> Dict:
    """The truth counts as a count table keyed by the catalogue's records
    (records with no support are left out, as a counter leaves them)."""
    return {key: [int(truth[i, 0]), int(truth[i, 1])]
            for i, (_, key) in enumerate(_typed_keys(catalogue_vcf))
            if truth[i].sum() > 0}


def _ad(column: str) -> Tuple[float, float]:
    parts = column.split(":")
    a, b = parts[2].split(",")
    return float(a), float(b)


def compare(catalogue_vcf: str, job_vcf: str, job_raw: Dict,
            ref_columns: List[str], min_support: int, err: float) -> Dict:
    """The job's numbers: ``ad_gap`` and ``model_mismatch``."""
    cat = vcf_records(catalogue_vcf)
    got = vcf_records(job_vcf)
    want_model = expected_columns(catalogue_vcf, job_raw, min_support, err)
    mismatch = abs(len(got) - len(cat))
    gap = total = 0.0
    for i, site in enumerate(cat):
        ra, rb = _ad(ref_columns[i])
        total += ra + rb
        if i >= len(got):
            gap += ra + rb
            continue
        rec = got[i]
        if rec[:8] != site[:8] or len(rec) != 10 or rec[8] != "GT:DP:AD:PL" \
                or rec[9] != want_model[i]:
            mismatch += 1
        try:
            ga, gb = _ad(rec[9])
        except (IndexError, ValueError):
            gap += ra + rb
            continue
        gap += abs(ga - ra) + abs(gb - rb)
    return {"ad_gap": gap / max(total, 1.0), "model_mismatch": mismatch}


def control_vcf(catalogue_vcf: str, raw: Dict, min_support: int,
                err: float) -> str:
    """The control: the reference in the program's place, with the
    guarantee "the two-breakpoint allele's count is halved" broken. The
    site columns are the catalogue's, the sample column the model's."""
    cols = expected_columns(catalogue_vcf, raw, min_support, err, halve=False)
    lines = ["\t".join(f[:8] + ["GT:DP:AD:PL", c])
             for f, c in zip(vcf_records(catalogue_vcf), cols)]
    return "\n".join(lines) + "\n"
