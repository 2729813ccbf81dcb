"""The control (the reference in the program's place with the halving of
the two-breakpoint allele broken) is not correct on three seeds, and the
reference judged against itself is."""

import pytest

from conftest import TINY_CONFIG, TINY_MIX

from benchmark import calibrate, cells, reference


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 3])
def test_control_is_not_correct(tmp_path, seed):
    cell = cells.load_cell("sim10mb-catalog1k.clr20x")
    cell.config.update(TINY_CONFIG, n_svs=30, genome_bp=250_000)
    cell.mix.update(TINY_MIX)
    g = cell.config["guarantees"]
    cat = cell.gen.make_catalogue(cell.config, seed)
    cat.write_vcf(tmp_path / "c.vcf")
    vcf = (tmp_path / "c.vcf").read_text()
    sample = cell.gen.make_sample(cat, cell.mix, seed, tmp_path / "s.fastq")
    got = calibrate.control_numbers(cell, cat, sample, vcf)
    assert got["ad_gap"] > cell.limits["ad_gap"]
    assert got["model_mismatch"] > cell.limits["model_mismatch"]

    ref = cell.reference
    truth = ref.truth_counts(cat, sample, g["d_over"])
    table = ref.reference_counts(vcf, truth)
    cols = ref.expected_columns(vcf, table, g["min_support"], g["err"])
    own = "\n".join("\t".join(f[:8] + ["GT:DP:AD:PL", c]) for f, c in
                    zip(ref.vcf_records(vcf), cols))
    assert ref.compare(vcf, own, table, cols, g["min_support"],
                       g["err"]) == {"ad_gap": 0.0, "model_mismatch": 0}


def test_model_agrees_with_the_programs_writer(tmp_path):
    """The reference's model, written apart from the program, gives the
    program's VCF column on a grid of counts."""
    from svjedi_tpu_torch.genotype.vcf_writer import write_genotyped_vcf

    lines, table = [], {}
    for i, svtype in enumerate(("DEL", "INS", "INV")):
        for a in range(0, 31, 3):
            for b in range(0, 31, 2):
                pos = 1000 * (i * 1000 + a * 40 + b + 1)
                if svtype == "INS":
                    alt, end, key = "A" * 60, pos + 1, f"c:INS-{pos}-1"
                else:
                    alt, end = f"<{svtype}>", pos + 60
                    key = f"c:{svtype}-{pos}-{end}"
                lines.append(f"c\t{pos}\tv\tN\t{alt}\t.\t.\t"
                             f"SVTYPE={svtype};END={end}")
                table[key] = [a, b]
    vcf = "#CHROM\n" + "\n".join(lines) + "\n"
    (tmp_path / "in.vcf").write_text(vcf)
    write_genotyped_vcf(tmp_path / "in.vcf", tmp_path / "out.vcf", table)
    got = [r[9] for r in reference.vcf_records(
        (tmp_path / "out.vcf").read_text())]
    assert got == reference.expected_columns(vcf, table, 3, 5e-05)
