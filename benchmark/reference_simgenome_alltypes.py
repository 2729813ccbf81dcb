"""The plain reference of the all-types catalogue (DEL, INS, INV and BND on
several chromosomes), and the comparison that decides ``correct``.

Nothing here imports the program. As ``reference.py``, it works from the
inputs the benchmark made (the catalogue's events and each read's origin on
its haplotype's derivative sequences) and from the configuration's stated
guarantees, written from SVJedi-graph's semantics (SURVEY.md section 3.2-3.4):

- Counting: a read supports an allele at a junction when it comes from a
  haplotype that carries that allele and covers at least ``d_over`` bases
  on each side of the junction; each (read, junction) counts once. The
  junctions are the generator's (``gen_simgenome_alltypes.junctions``).
- The chrom-prefix rule: a BND record's count-table key is
  ``<CHROM>:BND-<ALT with the REF token replaced by POS>``. The alt link
  carries the record's key; a reference link carries the record's id under
  the chromosome the link lies on. So a ref junction counts for a record
  only on the record's own chromosome: for an inter-chromosomal BND, ref
  reads at the mate chromosome's junction never count.
- Genotyping: SVJedi-graph's binomial model (``reference.genotype``, held to
  the program's writer by a CPU test), with the halving of each type: DEL
  ref, INS alt, INV and BND none (an intra-chromosomal BND's ref has two
  junctions and is not halved).

Two numbers are compared per job (:func:`compare`):

- ``ad_gap``: the largest over the SV types of Σ |AD − AD_ref| over Σ AD_ref
  within the type, so that a fault in the BND records is not diluted by the
  other three types;
- ``model_mismatch``: as in ``reference.py``; exact, its limit is 0.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from .reference import _ad, genotype, vcf_records

#: The SV types the catalogue holds, each judged on its own.
TYPES = ("DEL", "INS", "INV", "BND")


def truth_counts(cat, sample, d_over: int) -> np.ndarray:
    """(n_records, 2) raw [ref, alt] counts of the reads crossing each
    record's counted junctions by ``d_over`` bases on both sides."""
    from .gen_simgenome_alltypes import junctions

    counts = np.zeros((cat.n_svs, 2), dtype=np.int64)
    rec_chrom = [r.chrom for r in cat.records]
    ends = sample.start + sample.frag_len
    longest = int(sample.frag_len.max()) if len(sample.frag_len) else 0
    for hap in (0, 1):
        groups = {}
        for rec, allele, slot, j, link in junctions(cat, hap):
            # A ref link counts under its own chromosome's prefix only.
            if link >= 0 and link != rec_chrom[rec]:
                continue
            if slot not in groups:
                on = np.flatnonzero((sample.hap == hap)
                                    & (sample.slot == slot))
                order = np.argsort(sample.start[on], kind="stable")
                groups[slot] = (sample.start[on][order], ends[on][order])
            s, e = groups[slot]
            lo = np.searchsorted(s, j + d_over - longest, side="left")
            hi = np.searchsorted(s, j - d_over, side="right")
            counts[rec, allele] += int((e[lo:hi] >= j + d_over).sum())
    return counts


def _bnd_key(chrom: str, pos: str, alt: str) -> str:
    """SVJedi-graph's key of a BND record: its CHROM, then the ALT with the
    REF token (the part outside the brackets that is not the mate locus)
    replaced by POS."""
    bracket = "[" if "[" in alt else "]"
    head, _, rest = alt.partition(bracket)
    mate, _, tail = rest.partition(bracket)
    if ":" not in mate:
        raise ValueError(f"not a breakend ALT: {alt}")
    token = head if head else tail
    return f"{chrom}:BND-" + alt.replace(token, pos)


def _key(chrom: str, pos: str, svtype: str, alt: str, info: str,
         ins_seen: Dict[str, int]) -> str:
    """The count table's key of a VCF record (SVJedi-graph's sv ids; the
    INS multiplicity counts by POS alone, over all chromosomes)."""
    fields = dict(kv.split("=", 1) for kv in info.split(";") if "=" in kv)
    if svtype == "INS":
        ins_seen[pos] = ins_seen.get(pos, 0) + 1
        return f"{chrom}:INS-{pos}-{ins_seen[pos]}"
    if svtype in ("DEL", "INV"):
        return f"{chrom}:{svtype}-{pos}-{fields['END']}"
    if svtype == "BND":
        return _bnd_key(chrom, pos, alt)
    raise ValueError(f"no key for SVTYPE {svtype}")


def _typed_keys(catalogue_vcf: str) -> List[Tuple[str, str]]:
    """(SVTYPE, count-table key) of each catalogue record, in order."""
    out, ins_seen = [], {}
    for f in vcf_records(catalogue_vcf):
        svtype = dict(kv.split("=", 1) for kv in f[7].split(";")
                      if "=" in kv)["SVTYPE"]
        out.append((svtype, _key(f[0], f[1], svtype, f[4], f[7], ins_seen)))
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


def compare(catalogue_vcf: str, job_vcf: str, job_raw: Dict,
            ref_columns: List[str], min_support: int, err: float) -> Dict:
    """The job's numbers: ``ad_gap`` (the largest of the per-type gaps, each
    also given as ``ad_gap_<TYPE>``) and ``model_mismatch``."""
    cat = vcf_records(catalogue_vcf)
    types = [t for t, _ in _typed_keys(catalogue_vcf)]
    got = vcf_records(job_vcf)
    want_model = expected_columns(catalogue_vcf, job_raw, min_support, err)
    mismatch = abs(len(got) - len(cat))
    gap = dict.fromkeys(TYPES, 0.0)
    total = dict.fromkeys(TYPES, 0.0)
    for i, site in enumerate(cat):
        t = types[i]
        ra, rb = _ad(ref_columns[i])
        total[t] += ra + rb
        if i >= len(got):
            gap[t] += ra + rb
            continue
        rec = got[i]
        if rec[:8] != site[:8] or len(rec) != 10 or rec[8] != "GT:DP:AD:PL" \
                or rec[9] != want_model[i]:
            mismatch += 1
        try:
            ga, gb = _ad(rec[9])
        except (IndexError, ValueError):
            gap[t] += ra + rb
            continue
        gap[t] += abs(ga - ra) + abs(gb - rb)
    per_type = {t: gap[t] / max(total[t], 1.0) for t in TYPES}
    out = {"ad_gap": max(per_type.values()), "model_mismatch": mismatch}
    out.update({f"ad_gap_{t}": v for t, v in per_type.items()})
    return out


def control_vcf(catalogue_vcf: str, raw: Dict, min_support: int,
                err: float) -> str:
    """The control: the reference in the program's place, with the
    guarantee "the two-breakpoint allele's count is halved" broken. The
    site columns are the catalogue's, the sample column the model's."""
    cols = expected_columns(catalogue_vcf, raw, min_support, err, halve=False)
    lines = ["\t".join(f[:8] + ["GT:DP:AD:PL", c])
             for f, c in zip(vcf_records(catalogue_vcf), cols)]
    return "\n".join(lines) + "\n"
