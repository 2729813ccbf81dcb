# Copied verbatim from svjedi_tpu/graph/svparse.py.
"""VCF record → normalized SV descriptions, with reference-exact semantics.

This module reproduces the reference's SV-id scheme and BND breakend algebra
(construct-graph.py:606-660 ``format_*_id``, :662-734 ``parse_BND_id``,
:737-747 ``get_info``) because downstream key matching depends on it byte for
byte (predict-genotype.py re-derives the same ids at :118-211).

Quirks deliberately preserved (SURVEY §3.2):
- INS multiplicity counter keyed by the POS *string only* (not chromosome-
  qualified), incremented in VCF order even for records later discarded
  (construct-graph.py:134-140 happens before the discard checks at :143-159).
- BND id embeds the raw ALT with the REF token substring-replaced by POS
  (construct-graph.py:658 ``alt.replace(t, pos)``).
- DEL/INS/INV touching the last two bases of the chromosome are discarded
  (construct-graph.py:195-197); breakpoints at the chromosome extremities
  (pos <= 1 or pos >= len) are not placed (:206).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def get_info(info: str, label: str) -> Optional[str]:
    """Extract ``label=`` value from a VCF INFO field.

    Behaviorally equivalent to construct-graph.py:737-747 for well-formed
    INFO fields (first ``;``-separated field whose key matches wins); returns
    None when the label is absent (where the reference would crash).
    """
    prefix = label + "="
    for fld in info.split(";"):
        if fld.startswith(prefix):
            return fld[len(prefix) :]
    return None


@dataclass
class SVRecord:
    """One normalized SV from the input VCF."""

    chrom: str
    pos: int  # VCF POS (1-based)
    vcf_id: str
    svtype: str  # DEL / INS / INV / BND
    sv_id: str  # reference-scheme id, e.g. "DEL-10000-10500"
    end: int = 0  # END for DEL/INV; POS for INS
    ins_seq: str = ""  # insert sequence for INS
    ins_count: int = 0  # multiplicity for INS
    # BND fields: left/right (chrom, pos, strand) from parse_BND_id,
    # *uncorrected* (node lookup uses these raw values,
    # construct-graph.py:506-521), and the corrected breakpoint positions
    # used for breakpoint placement (:233-248).
    bnd_left: Optional[Tuple[str, int, str]] = None
    bnd_right: Optional[Tuple[str, int, str]] = None
    bnd_left_bkpt: Optional[Tuple[str, int]] = None
    bnd_right_bkpt: Optional[Tuple[str, int]] = None
    line: str = ""  # original VCF line (rstripped), for ledger/output


@dataclass
class ParsedVCF:
    """All SVs from a VCF, plus the discard ledger and breakpoint maps."""

    svs: List[SVRecord] = field(default_factory=list)
    #: Raw lines of records ignored due to wrong format
    #: (construct-graph.py ``l_discarded`` → ignored_svs.txt).
    discarded: List[str] = field(default_factory=list)
    #: chrom -> sorted unique breakpoint positions (after placement rules).
    chr_bkpt: Dict[str, List[int]] = field(default_factory=dict)
    #: chrom -> {bkpt_pos -> [sv_id, ...]} in VCF append order.
    bkpt_sv: Dict[str, Dict[int, List[str]]] = field(default_factory=dict)
    #: chrom -> [sv_id, ...] in VCF order (d_svs; drives alt-link emission).
    chrom_svs: Dict[str, List[str]] = field(default_factory=dict)
    #: sv_id -> original VCF ID column (last record wins on collision).
    sv_vcf_id: Dict[str, str] = field(default_factory=dict)


def format_del_id(pos: str, end: int) -> str:
    return f"DEL-{pos}-{end}"


def format_ins_id(pos: str, count: int) -> str:
    return f"INS-{pos}-{count}"


def format_inv_id(pos: str, end: int) -> str:
    return f"INV-{pos}-{end}"


def format_bnd_id(pos: str, alt: str) -> Optional[str]:
    """Reference BND id: the ALT string with the REF token replaced by POS.

    Mirrors construct-graph.py:615-660 including the substring-replace quirk.
    Returns None for bracket-less ALTs (the reference returns "BND-format",
    which parse_BND_id then fails on; net effect is a discard).
    """
    if "[" in alt:
        parts = [s for s in alt.split("[") if s]
        if len(parts) < 2:
            return None
        # t[p[ : p carries the mate "chrom:pos"; else [p[t.
        t = parts[0] if ":" in parts[1] else parts[1]
    elif "]" in alt:
        parts = [s for s in alt.split("]") if s]
        if len(parts) < 2:
            return None
        t = parts[0] if ":" in parts[1] else parts[1]
    else:
        return None
    return "BND-" + alt.replace(t, pos)


def parse_bnd_id(
    chrom: str, bnd_id: str
) -> Tuple[Optional[List], Optional[List]]:
    """Recover (left, right) = [chrom, pos, strand] from a BND id.

    Mirrors construct-graph.py:662-734: the four breakend flavors map to
    left/right endpoints with strands; '-' marks the reverse-complemented
    side ([p[t: left '-' ; t]p]: right '-').
    """
    alt = bnd_id.split("BND-", 1)[1]
    if "[" in alt:
        parts = [s for s in alt.split("[") if s]
        if len(parts) >= 2 and ":" in parts[1]:
            # t[p[ : piece right of p joined after t.
            mate_chrom, mate_pos = parts[1].split(":", 1)
            return [chrom, int(parts[0]), "+"], [mate_chrom, int(mate_pos), "+"]
        if len(parts) >= 2 and ":" in parts[0]:
            # [p[t : revcomp piece right of p joined before t.
            mate_chrom, mate_pos = parts[0].split(":", 1)
            return [mate_chrom, int(mate_pos), "-"], [chrom, int(parts[1]), "+"]
    elif "]" in alt:
        parts = [s for s in alt.split("]") if s]
        if len(parts) >= 2 and ":" in parts[1]:
            # t]p] : revcomp piece left of p joined after t.
            mate_chrom, mate_pos = parts[1].split(":", 1)
            return [chrom, int(parts[0]), "+"], [mate_chrom, int(mate_pos), "-"]
        if len(parts) >= 2 and ":" in parts[0]:
            # ]p]t : piece left of p joined before t.
            mate_chrom, mate_pos = parts[0].split(":", 1)
            return [mate_chrom, int(mate_pos), "+"], [chrom, int(parts[1]), "+"]
    return None, None


def corrected_bnd_breakpoints(left: List, right: List) -> Tuple[Tuple, Tuple]:
    """Strand-correct BND breakpoint positions for placement.

    construct-graph.py:229-248: both '+' → right.pos -= 1 (covers t[p[ and
    ]p]t); left '-' ([p[t) → both -= 1; right '-' (t]p]) → unchanged.
    """
    lc, lp, ls = left
    rc, rp, rs = right
    if ls == "+" and rs == "+":
        rp -= 1
    elif ls == "-":
        lp -= 1
        rp -= 1
    return (lc, lp), (rc, rp)


class VCFError(ValueError):
    pass


def parse_vcf_svs(vcf_path, chrom_lengths: Dict[str, int]) -> ParsedVCF:
    """Parse a VCF into normalized SVs + breakpoint maps.

    ``chrom_lengths`` comes from the reference FASTA; a VCF chromosome
    missing from it is a hard error (construct-graph.py:124-125).
    """
    out = ParsedVCF()
    for chrom in chrom_lengths:
        out.chr_bkpt[chrom] = []
        out.chrom_svs[chrom] = []
    bkpt_sets: Dict[str, set] = {c: set() for c in chrom_lengths}
    ins_multiplicity: Dict[str, int] = {}
    ins_seqs: Dict[str, str] = {}

    def place_bkpt(chrom: str, pos: int, sv_id: str) -> None:
        # Extremity rule: construct-graph.py:206 / :258.
        if not (1 < pos < chrom_lengths[chrom]):
            return
        bkpt_sets[chrom].add(pos)
        out.bkpt_sv.setdefault(chrom, {}).setdefault(pos, []).append(sv_id)

    with open(vcf_path) as fh:
        for raw in fh:
            if raw.startswith("#"):
                continue
            line = raw.rstrip()
            fields = line.split("\t")
            if len(fields) < 8:
                continue
            chrom, pos_str, vcf_id, ref, alt = fields[:5]
            info = fields[7]
            if chrom not in chrom_lengths:
                raise VCFError(
                    f"sequence '{chrom}' from input VCF is missing in reference "
                    "genome; chromosomes must have the same names in input VCF "
                    "and reference genome files"
                )
            svtype = get_info(info, "SVTYPE")
            pos = int(pos_str)
            rec = SVRecord(
                chrom=chrom, pos=pos, vcf_id=vcf_id, svtype=svtype or "",
                sv_id="", line=line,
            )

            if svtype == "DEL":
                end = int(get_info(info, "END"))
                rec.end = end
                rec.sv_id = format_del_id(pos_str, end)
            elif svtype == "INS":
                rec.end = pos
                # Multiplicity bump happens before any discard check
                # (construct-graph.py:134-140).
                ins_multiplicity[pos_str] = ins_multiplicity.get(pos_str, 0) + 1
                rec.ins_count = ins_multiplicity[pos_str]
                rec.sv_id = format_ins_id(pos_str, rec.ins_count)
                if len(ref) > 1:
                    out.discarded.append(line)
                    continue
                if alt.startswith("<"):
                    if "LEFT_SVINSSEQ=" in info or "RIGHT_SVINSSEQ=" in info:
                        out.discarded.append(line)
                        continue
                    seq = get_info(info, "SEQ") if "SEQ=" in info else None
                    if seq is None:
                        out.discarded.append(line)
                        continue
                    ins_seqs[rec.sv_id] = seq
                elif rec.sv_id not in ins_seqs:
                    ins_seqs[rec.sv_id] = alt.upper()
                rec.ins_seq = ins_seqs[rec.sv_id]
            elif svtype == "INV":
                end = int(get_info(info, "END"))
                rec.end = end
                rec.sv_id = format_inv_id(pos_str, end)
            elif svtype == "BND":
                sv_id = format_bnd_id(pos_str, alt)
                if sv_id is None:
                    # Reference yields "BND-format" whose parse fails → discard.
                    out.discarded.append(line)
                    continue
                rec.sv_id = sv_id
            else:
                # Unsupported SVTYPE: silently skipped, not even ledgered
                # (construct-graph.py:174-176).
                continue

            out.sv_vcf_id[rec.sv_id] = vcf_id

            if svtype in ("DEL", "INS", "INV"):
                end = rec.end
                # Last-two-bases discard rule (construct-graph.py:195-197).
                if (
                    end >= chrom_lengths[chrom] - 1
                    or pos >= chrom_lengths[chrom] - 1
                ):
                    out.discarded.append(line)
                    continue
                for bkpt in sorted({pos, end}):
                    place_bkpt(chrom, bkpt, rec.sv_id)
                out.chrom_svs[chrom].append(rec.sv_id)
            else:  # BND
                left, right = parse_bnd_id(chrom, rec.sv_id)
                if left is None:
                    out.discarded.append(line)
                    continue
                rec.bnd_left = tuple(left)
                rec.bnd_right = tuple(right)
                for bc in (left[0], right[0]):
                    if bc not in chrom_lengths:
                        raise VCFError(
                            f"BND mate chromosome '{bc}' missing from reference"
                        )
                lb, rb = corrected_bnd_breakpoints(list(left), list(right))
                rec.bnd_left_bkpt = lb
                rec.bnd_right_bkpt = rb
                for bchrom, bpos in (lb, rb):
                    place_bkpt(bchrom, bpos, rec.sv_id)
                out.chrom_svs[chrom].append(rec.sv_id)

            out.svs.append(rec)

    for chrom, s in bkpt_sets.items():
        # Node-boundary filter: drop breakpoints at >= len-1
        # (construct-graph.py:302-307).
        out.chr_bkpt[chrom] = sorted(
            b for b in s if b < chrom_lengths[chrom] - 1
        )
    return out
