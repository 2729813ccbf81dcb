# Copied verbatim from svjedi_tpu/evals/contingency.py.
"""Genotype-concordance contingency table (reference: test-dir/contingency_table.py).

Produces output text identical to the reference harness so golden ``.eval``
files diff-equal (the reference CI's primary PASS check, run_test.sh:32-34).
Variants join on ``chrom_pos-length``; FN ≡ predicted ``./.``; FP ≡ wrong
non-missing genotype; accuracy = TP/(TP+FP); rate = (TP+FP)/(TP+FP+FN).
"""

from __future__ import annotations

import io
from typing import Dict

import numpy as np

_TRUTH_GT = {
    "0/0": "0", "0|0": "0",
    "0/1": "1", "0|1": "1", "1|0": "1",
    "1/1": "2", "1|1": "2",
}
_PRED_GT = {"0/0": "0", "0/1": "1", "1/1": "2", "./.": "3"}


def _sv_length(info: str, start: str, truth: bool) -> int:
    length = info.split("SVLEN=")[1].split(";")[0]
    if length in ("False", "0"):
        # The reference splits truth on ';END=' and predictions on 'END='
        # (contingency_table.py:22 vs :44); preserved for exactness.
        end = info.split(";END=" if truth else "END=")[1].split(";")[0]
        return int(end) - int(start)
    return abs(int(length))


def _load(path, gt_map: Dict[str, str], truth: bool) -> Dict[str, str]:
    out: Dict[str, str] = {}
    with open(path) as fh:
        for line in fh:
            if line.startswith("#") or len(line.split("\t")) <= 2:
                continue
            fields = line.rstrip("\n").split("\t")
            chrom, start, info, sample = fields[0], fields[1], fields[7], fields[9]
            genotype = sample.split(":")[0]
            if truth and genotype not in gt_map:
                continue
            length = _sv_length(info, start, truth)
            out[f"{chrom}_{start}-{length}"] = gt_map.get(genotype, genotype)
    return out


def contingency_report(truth_vcf, predicted_vcf) -> str:
    """Return the report text (identical to the reference script's stdout)."""
    truth = _load(truth_vcf, _TRUTH_GT, truth=True)
    pred = _load(predicted_vcf, _PRED_GT, truth=False)

    table = np.zeros((3, 4), dtype=np.int64)
    fp = fn = 0
    buf = io.StringIO()
    for key, tgt in truth.items():
        if key in pred:
            table[int(tgt), int(pred[key])] += 1
            if pred[key] == "3":
                fn += 1
            elif tgt != pred[key]:
                fp += 1
                print("FP = " + key, file=buf)
    tp = int(sum(table[i][i] for i in range(3)))

    print("---------------------", file=buf)
    print("Table of contingency:", file=buf)
    print(table, file=buf)
    print(file=buf)
    print("Genotyping accuracy: " + str(round(tp / (tp + fp) * 100, 1)), file=buf)
    print(
        "Genotyping rate: " + str(round((tp + fp) / (tp + fp + fn) * 100, 1)),
        file=buf,
    )
    print("Number of predicted SV: " + str(len(pred) - fn), file=buf)
    print("Number of unpredicted SV: " + str(fn), file=buf)
    print("Number of known SVs: " + str(len(truth)), file=buf)
    return buf.getvalue()
