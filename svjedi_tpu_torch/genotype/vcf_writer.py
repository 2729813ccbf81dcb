# Copied verbatim from svjedi_tpu/genotype/vcf_writer.py.
"""Genotyped-VCF emission with byte parity to predict-genotype.py:89-279.

The writer re-reads the input VCF and re-derives each record's sv_id with the
same scheme as the graph builder (including its own INS multiplicity counter,
predict-genotype.py:150-157 — order- and file-dependent on purpose), looks
the id up in the support table, runs the likelihood model, and appends a
``GT:DP:AD:PL`` sample column. Header behavior: ``##FORMAT`` lines dropped
and replaced by four fixed definitions; fixed ``#CHROM…SAMPLE`` column
header; any pre-existing sample columns stripped (:102-115, :250-271).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

from .likelihood import genotype_one

_FORMAT_HEADERS = (
    '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
    '##FORMAT=<ID=DP,Number=1,Type=Float,Description="Total number of informative read alignments across all alleles (after normalization for unbalanced SVs)">\n'
    '##FORMAT=<ID=AD,Number=2,Type=Float,Description="Number of informative read alignments supporting each allele (after normalization by breakpoint number for unbalanced SVs)">\n'
    '##FORMAT=<ID=PL,Number=3,Type=Integer,Description="Phred-scaled likelihood for each genotype">\n'
)
_COLUMN_HEADER = "#CHROM	POS	ID	REF	ALT	QUAL	FILTER	INFO	FORMAT	SAMPLE\n"
_GENOTYPE_FORMAT = "GT:DP:AD:PL"


def derive_record_key(
    chrom: str,
    pos: str,
    alt: str,
    info: str,
    ins_multiplicity: Dict[str, int],
) -> Tuple[str, str, Union[int, float]]:
    """Re-derive (svtype, lookup key, length) for one VCF record.

    Mirrors predict-genotype.py:118-211: SVTYPE extracted with the last/first
    field logic, END only for DEL/INV, INS multiplicity keyed by POS string
    only, BND key rebuilt from the ALT with POS substituted (via f-string
    rather than substring replace — the two differ only when the REF token
    appears inside the mate locus, where the reference's own two stages
    disagree with each other; we match predict-genotype, the stage that
    defines the lookup).
    """
    svtype = ""
    if "SVTYPE" in info:
        if info.split(";")[-1].startswith("SVTYPE="):
            svtype = info.split("SVTYPE=")[1]
        else:
            svtype = info.split("SVTYPE=")[1].split(";")[0]

    def get_end() -> str:
        if info.split(";")[0].startswith("END="):
            return info.split("END=")[1].split(";")[0]
        if info.split(";")[-1].startswith("END="):
            return info.split(";END=")[1]
        return info.split(";END=")[1].split(";")[0]

    if svtype == "DEL":
        end = get_end()
        return svtype, f"{chrom}:DEL-{pos}-{end}", int(end) - int(pos)
    if svtype == "INS":
        ins_multiplicity[pos] = ins_multiplicity.get(pos, 0) + 1
        return svtype, f"{chrom}:INS-{pos}-{ins_multiplicity[pos]}", len(alt)
    if svtype == "INV":
        end = get_end()
        return svtype, f"{chrom}:INV-{pos}-{end}", int(end) - int(pos)
    if svtype == "BND":
        key = f"{chrom}:BND-"
        if "[" in alt:
            parts = [s for s in alt.split("[") if s]
            if ":" in parts[1]:
                key += f"{pos}[{parts[1]}["
            else:
                key += f"[{parts[0]}[{pos}"
        elif "]" in alt:
            parts = [s for s in alt.split("]") if s]
            if ":" in parts[1]:
                key += f"{pos}]{parts[1]}]"
            else:
                key += f"]{parts[0]}]{pos}"
        else:
            key = "wrong_format"
        return svtype, key, 50
    return svtype, "unsupported_type", 0


def _format_count(value) -> str:
    """str() of an int-or-float count, preserving the reference's types."""
    return str(value)


def write_genotyped_vcf(
    input_vcf,
    output_vcf,
    support_counts: Dict[str, Sequence[float]],
    min_support: int = 3,
    err: float = 0.00005,
) -> Dict[str, int]:
    """Write the genotyped VCF. Returns summary stats.

    ``support_counts`` maps lookup keys ("{chrom}:{sv_id}") to raw
    [ref_count, alt_count]; ints stay ints so DP/AD render exactly like the
    reference (e.g. ``19.5:9.5,10``).
    """
    ins_multiplicity: Dict[str, int] = {}
    genotyped = 0
    ungenotyped = 0

    with open(input_vcf) as src, open(output_vcf, "w") as dst:
        for line in src:
            if line.startswith("##FORMAT"):
                continue
            if line.startswith("##"):
                dst.write(line)
                continue
            if line.startswith("#C"):
                dst.write(_FORMAT_HEADERS)
                dst.write(_COLUMN_HEADER)
                continue

            fields = line.rstrip("\n").split("\t")
            chrom, pos, alt, info = fields[0], fields[1], fields[4], fields[7]
            svtype, key, length = derive_record_key(
                chrom, pos, alt, info, ins_multiplicity
            )

            if (
                svtype in ("DEL", "INS", "INV", "BND")
                and key in support_counts
                and abs(length) >= 50
            ):
                raw = list(support_counts[key])
                geno, pl, norm = genotype_one(raw, svtype, min_support, err)
                counts: List = norm
                genotyped += 1
            else:
                counts = [0, 0]
                geno = "./."
                pl = [".", ".", "."]
                ungenotyped += 1

            numbers = ",".join(_format_count(c) for c in counts)
            if len(line.split("\t")) <= 8:
                prefix = line.rstrip("\n")
            else:
                prefix = "\t".join(line.split("\t")[0:8])
            dst.write(
                prefix
                + "\t"
                + _GENOTYPE_FORMAT
                + "\t"
                + geno
                + ":"
                + str(round(sum(counts), 3))
                + ":"
                + numbers
                + ":"
                + ",".join(pl)
                + "\n"
            )

    return {"genotyped_svs": genotyped, "ungenotyped_svs": ungenotyped}
