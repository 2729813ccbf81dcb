"""Command-line interface: the flags of ``python -m svjedi_tpu``, run on PyTorch.

The parser is a verbatim copy of the JAX CLI's, so every flag stays
identical; :func:`port_parser` adds ``run --device`` (the counterpart of the
JAX CLI's ``JAX_PLATFORMS``: the card unless ``--device cpu``). ``run`` and
``merge`` go to this package's pipeline; ``graph``, ``filter``, ``predict``
and ``eval`` call this package's copies of the same JAX-free functions.
"""

from __future__ import annotations

import argparse
import json
import sys


# Copied verbatim from svjedi_tpu/cli.py:_add_run.
def _add_run(sub):
    p = sub.add_parser("run", help="full pipeline")
    p.add_argument("-v", "--vcf", required=True, help="SV set in vcf format")
    p.add_argument("-r", "--ref", required=True, help="Reference genome in fasta format")
    p.add_argument(
        "-q", "--reads", required=True,
        help="Long reads in fasta/fastq(.gz); comma-separated list allowed",
    )
    p.add_argument("-p", "--prefix", required=True, help="Prefix of generated files")
    p.add_argument(
        "-t", "--threads", type=int, default=0,
        help="Host threads for native seeding scans (0 = all cores); "
             "device parallelism scales via --shard / the device mesh",
    )
    p.add_argument(
        "-ms", "--minsupport", type=int, default=3,
        help="Minimum number of alignments to genotype a SV (default: 3>=)",
    )
    p.add_argument("-e", "--err", type=float, default=0.00005,
                   help="allele error probability")
    p.add_argument("--no-artifacts", action="store_true",
                   help="skip writing intermediate artifacts")
    p.add_argument("--gaf", action="store_true",
                   help="also write <prefix>.gaf (minigraph-style records "
                        "for the winning alignments; interop/debugging)")
    p.add_argument(
        "--shard", default=None, metavar="I/N",
        help="multi-host data parallelism: process read block I of N and "
             "write a shard audit table; finish with the merge command",
    )
    p.add_argument(
        "--data-shards", type=int, default=1, metavar="N",
        help="single-host multi-chip data parallelism: round-robin read "
             "chunks over the first N local devices (panel replicated per "
             "chip; counts merge associatively)",
    )
    p.add_argument(
        "--graph-shards", type=int, default=1, metavar="G",
        help="on-mesh SPMD counting: run the per-(SV, allele) count merge "
             "under shard_map on a (data x graph) device mesh (entries "
             "sharded over data, SV tag ranges over G graph shards, one "
             "psum); byte-equal to the host reduction",
    )
    p.add_argument(
        "--decoy-shards", type=int, default=1, metavar="G",
        help="split the whole-genome decoy index into G genomic-range "
             "shards (the Gb-scale memory lever; byte-equal to unsharded "
             "— on a process grid each host builds only its shard)",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="pod-slice mode: join the jax.distributed process group, "
             "shard reads by process index, allreduce counts over the "
             "fabric, genotype on process 0 (no shared filesystem needed)",
    )
    p.add_argument(
        "--no-stream", action="store_true",
        help="load all reads resident instead of streaming them from disk "
             "in O(chunk) memory (streaming is the default and "
             "byte-identical; shard/multihost modes always load resident)",
    )
    p.add_argument("--profile-dir", default=None,
                   help="capture a JAX profiler trace into this directory")
    p.add_argument(
        "--resume", action="store_true",
        help="skip stages whose artifacts already exist (the aligner is "
             "skipped when <prefix>_informative_aln.json is present)",
    )


# Copied verbatim from svjedi_tpu/cli.py:_add_stage_parsers.
def _add_stage_parsers(sub):
    g = sub.add_parser("graph", help="construct graph artifacts only")
    g.add_argument("-v", "--vcf", required=True)
    g.add_argument("-r", "--ref", required=True)
    g.add_argument("-o", "--output", required=True, help="output GFA path")

    f = sub.add_parser("filter", help="filter an external GAF (interop)")
    f.add_argument("-a", "--gaf", required=True)
    f.add_argument("-g", "--gfa", required=True)
    f.add_argument("-p", "--prefix", required=True)
    f.add_argument("-O", "--dover", type=int, default=100)

    pr = sub.add_parser("predict", help="genotype from informative-aln JSON")
    pr.add_argument("-d", "--aln", required=True)
    pr.add_argument("-v", "--vcf", required=True)
    pr.add_argument("-o", "--output", required=True)
    pr.add_argument("-ms", "--minsupport", type=int, default=3)
    pr.add_argument("-e", "--err", type=float, default=0.00005)

    e = sub.add_parser("eval", help="genotype concordance table")
    e.add_argument("truth_vcf")
    e.add_argument("predicted_vcf")

    mg = sub.add_parser(
        "merge", help="merge shard audit tables and genotype once"
    )
    mg.add_argument("-v", "--vcf", required=True)
    mg.add_argument("-p", "--prefix", required=True)
    mg.add_argument("-n", "--shards", type=int, required=True)
    mg.add_argument("-o", "--output", default=None)
    mg.add_argument("-ms", "--minsupport", type=int, default=3)
    mg.add_argument("-e", "--err", type=float, default=0.00005)


# Copied verbatim from svjedi_tpu/cli.py:build_parser.
def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="svjedi_tpu",
        description="TPU-native structural-variant genotyping for long reads",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_run(sub)
    _add_stage_parsers(sub)
    return parser


def port_parser() -> argparse.ArgumentParser:
    """:func:`build_parser` with this package's name, help and ``--device``."""
    parser = build_parser()
    parser.prog = "svjedi_tpu_torch"
    parser.description = (
        "Structural-variant genotyping for long reads (PyTorch + CUDA)"
    )
    run = parser._subparsers._group_actions[0].choices["run"]
    for action in run._actions:
        if action.dest == "profile_dir":
            action.help = "capture a torch.profiler trace into this directory"
    run.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="run on the GPU (default; fails when none is visible) or on "
             "the CPU",
    )
    return parser


def main(argv=None) -> int:
    args = port_parser().parse_args(argv)

    if args.command == "run":
        import torch

        from .config import (
            AlignConfig, DistConfig, GenotypeConfig, PipelineConfig,
        )
        from .pipeline import run_pipeline, select_device

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
        device = (torch.device("cpu") if args.device == "cpu"
                  else select_device())
        result = run_pipeline(cfg, device=device)
        if args.multihost:
            from .dist.multihost import shutdown

            shutdown()
        if shard is not None:
            print(f"Shard audit written: {result['shard_json']}")
        elif result.get("output_vcf") is None:
            print("Host done; genotyping runs on process 0")
        else:
            print(
                "Genotyped svs: "
                f"{result['stats'].counters['genotyped_svs']}"
            )
        return 0

    if args.command == "graph":
        from .graph.build import (
            build_graph, write_gfa, write_ignored_svs, write_svs_edges_json,
        )
        from .graph.svparse import parse_vcf_svs
        from .io.fasta import read_fasta

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
        from .genotype.filter_gaf import (
            filter_gaf_files, write_informative_json,
        )

        informative = filter_gaf_files(
            args.gaf, args.gfa, f"{args.prefix}_svs_edges.json", args.dover
        )
        write_informative_json(informative, f"{args.prefix}_informative_aln.json")
        return 0

    if args.command == "predict":
        from .genotype.filter_gaf import counts_from_informative
        from .genotype.vcf_writer import write_genotyped_vcf

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
        from .evals.contingency import contingency_report

        sys.stdout.write(contingency_report(args.truth_vcf, args.predicted_vcf))
        return 0

    return 2


if __name__ == "__main__":
    raise SystemExit(main())
