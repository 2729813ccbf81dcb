"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a genotyping job can have, and true when it is not.
(A one-chip cell has no exchange between chips to leave out.)"""

import numpy as np
import pytest

from conftest import run_tiny


def test_sound_run_is_correct(tiny_cell):
    res = run_tiny(tiny_cell, 41)
    assert res["correct"] is True
    assert res["checks"]["ad_gap"]["value"] <= 0.02


def test_state_returned_unchanged(tiny_cell, monkeypatch):
    """The count step hands back its table as it started: empty."""
    from svjedi_tpu_torch.align import pipeline as ap

    orig = ap.align_and_count

    def unchanged(*a, **k):
        _, audit, winners = orig(*a, **k)
        return {}, audit, winners

    monkeypatch.setattr(ap, "align_and_count", unchanged)
    res = run_tiny(tiny_cell, 42)
    assert res["correct"] is False
    assert res["checks"]["ad_gap"]["value"] == pytest.approx(1.0)


def test_half_of_each_chunk_left_out(tiny_cell, monkeypatch):
    """Every chunk the stream yields loses its second half."""
    from svjedi_tpu_torch.io import fastq

    orig = fastq.ReadStream.chunks

    def half(self, chunk_reads, first=None):
        for chunk in orig(self, chunk_reads, first=first):
            yield chunk.slice(0, max(1, chunk.n_reads // 2))

    monkeypatch.setattr(fastq.ReadStream, "chunks", half)
    res = run_tiny(tiny_cell, 43)
    assert res["correct"] is False
    assert res["checks"]["ad_gap"]["value"] > 0.3


def test_answer_altered_where_produced(tiny_cell, monkeypatch):
    """The genotyper writes the GT of every INS record wrong."""
    from svjedi_tpu_torch.genotype import vcf_writer

    orig = vcf_writer.genotype_one

    def altered(counts, svtype, min_support, err):
        gt, pl, norm = orig(counts, svtype, min_support, err)
        if svtype == "INS":
            gt = "1/1" if gt != "1/1" else "0/0"
        return gt, pl, norm

    monkeypatch.setattr(vcf_writer, "genotype_one", altered)
    res = run_tiny(tiny_cell, 44)
    assert res["correct"] is False
    assert res["checks"]["model_mismatch"]["value"] >= 1
    assert np.isfinite(res["checks"]["ad_gap"]["value"])
