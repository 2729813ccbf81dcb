"""Readings that the limits of ``correct`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-only]

For each seed, in one process: the cell's set-up as ``run.py`` makes it,
one job of the program, and the job's numbers (``ad_gap``,
``model_mismatch``); then the control's numbers on the same inputs: the
reference put in the program's place with the guarantee "the count of the
allele with two breakpoints is halved" broken (``control_vcf`` of the
configuration's reference, ``cell.reference``).
One JSON line per seed and side on standard output. ``--control-only``
skips the program (the control needs no card). The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cells as cellmod  # noqa: E402


def control_numbers(cell, cat, sample, vcf_text: str) -> dict:
    """The control's numbers on the cell's inputs, by the cell's
    reference."""
    ref, g = cell.reference, cell.config["guarantees"]
    truth = ref.truth_counts(cat, sample, g["d_over"])
    table = ref.reference_counts(vcf_text, truth)
    ref_cols = ref.expected_columns(vcf_text, table, g["min_support"],
                                    g["err"])
    ctl = ref.control_vcf(vcf_text, table, g["min_support"], g["err"])
    return ref.compare(vcf_text, ctl, table, ref_cols, g["min_support"],
                       g["err"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args(argv)
    cell = cellmod.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = None
    if not args.control_only:
        import torch

        from benchmark import run

        if not torch.cuda.is_available():
            print("the program's readings need a CUDA device", file=sys.stderr)
            return 2
        card = run.Card(1)
        card.build()
        device = card.device
    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="svjt-calib-") as tmp:
            tmp = Path(tmp)
            if device is not None:
                setup = run.Setup(cell, seed, device, tmp)
                job = setup.job(0)
                checks = run.judge(setup, [job], cell.limits)
                print(json.dumps({"workload": cell.name, "seed": seed,
                                  "side": "program", "seconds": job.seconds,
                                  **{k: c["value"] for k, c in
                                     checks.items()}}), flush=True)
                cat, sample = setup.cat, setup.sample
                vcf_text = setup.vcf_path.read_text()
            else:
                cat = cell.gen.make_catalogue(cell.config, seed)
                cat.write_vcf(tmp / "catalogue.vcf")
                vcf_text = (tmp / "catalogue.vcf").read_text()
                sample = cell.gen.make_sample(cat, cell.mix, seed,
                                              tmp / "sample.fastq")
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "side": "control",
                              **control_numbers(cell, cat, sample,
                                                vcf_text)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
