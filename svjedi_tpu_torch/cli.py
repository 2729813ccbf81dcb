"""Command-line interface: the flags of ``python -m svjedi_tpu``, run on PyTorch.

The parser is :func:`svjedi_tpu.cli.build_parser` itself, so every flag
stays identical. ``run`` and ``merge`` go to this package's pipeline;
``graph``, ``filter``, ``predict`` and ``eval`` call the same JAX-free
functions as the JAX CLI.
"""

from __future__ import annotations

import json
import sys

from svjedi_tpu.cli import build_parser as _build_parser


def build_parser():
    parser = _build_parser()
    parser.prog = "svjedi_tpu_torch"
    parser.description = (
        "Structural-variant genotyping for long reads (PyTorch + CUDA)"
    )
    run = parser._subparsers._group_actions[0].choices["run"]
    for action in run._actions:
        if action.dest == "profile_dir":
            action.help = "capture a torch.profiler trace into this directory"
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.command == "run":
        from svjedi_tpu.config import (
            AlignConfig, DistConfig, GenotypeConfig, PipelineConfig,
        )

        from .pipeline import run_pipeline

        print("Constructing variation graph and panel...")
        shard = None
        if args.shard:
            i, n = args.shard.split("/")
            shard = (int(i), int(n))
        cfg = PipelineConfig(
            vcf=args.vcf,
            ref=args.ref,
            reads=tuple(args.reads.split(",")),
            prefix=args.prefix,
            align=AlignConfig(threads=max(0, args.threads)),
            genotype=GenotypeConfig(min_support=args.minsupport, err=args.err),
            dist=DistConfig(
                data_shards=max(1, args.data_shards),
                graph_shards=max(1, args.graph_shards),
                decoy_shards=max(1, args.decoy_shards),
            ),
            multihost=args.multihost,
            shard=shard,
            stream_reads=False if args.no_stream else None,
            keep_artifacts=not args.no_artifacts,
            resume=args.resume,
            write_gaf=args.gaf,
            profile_dir=args.profile_dir,
        )
        result = run_pipeline(cfg)
        if shard is not None:
            print(f"Shard audit written: {result['shard_json']}")
        else:
            print(
                "Genotyped svs: "
                f"{result['stats'].counters['genotyped_svs']}"
            )
        return 0

    if args.command == "graph":
        from svjedi_tpu.graph.build import (
            build_graph, write_gfa, write_ignored_svs, write_svs_edges_json,
        )
        from svjedi_tpu.graph.svparse import parse_vcf_svs
        from svjedi_tpu.io.fasta import read_fasta

        chroms = read_fasta(args.ref)
        parsed = parse_vcf_svs(args.vcf, {c: len(s) for c, s in chroms.items()})
        graph = build_graph(chroms, parsed)
        out = args.output
        prefix = out.replace(".gfa", "_") if out.endswith(".gfa") else out + "_"
        write_gfa(graph, out)
        write_svs_edges_json(graph, f"{prefix}svs_edges.json")
        write_ignored_svs(parsed, f"{prefix}ignored_svs.txt")
        return 0

    if args.command == "filter":
        from svjedi_tpu.genotype.filter_gaf import (
            filter_gaf_files, write_informative_json,
        )

        informative = filter_gaf_files(
            args.gaf, args.gfa, f"{args.prefix}_svs_edges.json", args.dover
        )
        write_informative_json(informative, f"{args.prefix}_informative_aln.json")
        return 0

    if args.command == "predict":
        from svjedi_tpu.genotype.filter_gaf import counts_from_informative
        from svjedi_tpu.genotype.vcf_writer import write_genotyped_vcf

        with open(args.aln) as fh:
            informative = json.load(fh)
        counts = counts_from_informative(informative)
        summary = write_genotyped_vcf(
            args.vcf, args.output, counts,
            min_support=args.minsupport, err=args.err,
        )
        print("Genotyped svs: " + str(summary["genotyped_svs"]))
        return 0

    if args.command == "merge":
        from .pipeline import merge_shards

        result = merge_shards(
            args.vcf, args.prefix, args.shards, out_vcf=args.output,
            min_support=args.minsupport, err=args.err,
        )
        print("Genotyped svs: " + str(result["summary"]["genotyped_svs"]))
        return 0

    if args.command == "eval":
        from svjedi_tpu.evals.contingency import contingency_report

        sys.stdout.write(contingency_report(args.truth_vcf, args.predicted_vcf))
        return 0

    return 2


if __name__ == "__main__":
    raise SystemExit(main())
