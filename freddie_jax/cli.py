"""Command-line interface.

Mirrors the reference's four stage CLIs (flag names included) plus a
`pipeline` subcommand that chains them (replacing the reference's
Snakemake orchestration):

    python -m freddie_jax.cli split    -b BAM -r READS... -o DIR
    python -m freddie_jax.cli segment  -s SPLIT_DIR -o DIR
    python -m freddie_jax.cli cluster  -s SEGMENT_DIR -o DIR
    python -m freddie_jax.cli isoforms -s SPLIT_DIR -c CLUSTER_DIR -o GTF
    python -m freddie_jax.cli pipeline -b BAM -r READS... -o DIR [--config YAML]

Reference flag tables: py/freddie_split.py:16-52, py/freddie_segment.py:53-110,
py/freddie_cluster.py:37-110, py/freddie_isoforms.py:10-47.
"""

from __future__ import annotations

import argparse
import sys
import time

from .config import (
    ClusterConfig,
    IsoformsConfig,
    PipelineConfig,
    SegmentConfig,
    SplitConfig,
)


def _str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in {"false", "f", "0", "no", "n"}:
        return False
    if v.lower() in {"true", "t", "1", "yes", "y"}:
        return True
    raise argparse.ArgumentTypeError(f"{v} is not a valid boolean value")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="freddie-jax")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("split", help="BAM -> transcriptional intervals")
    sp.add_argument("-b", "--bam", required=True)
    sp.add_argument("-r", "--reads", nargs="+", required=True)
    sp.add_argument("--consider-nonspliced", type=_str2bool, nargs="?", const=True, default=False)
    sp.add_argument("--contig-min-size", type=int, default=1_000_000)
    sp.add_argument("-t", "--threads", type=int, default=1)
    sp.add_argument("-o", "--outdir", default="freddie_split/")

    sg = sub.add_parser("segment", help="splice-signal segmentation")
    sg.add_argument("-s", "--split-dir", required=True)
    sg.add_argument("--consider-ends", type=_str2bool, nargs="?", const=True, default=False)
    sg.add_argument("-o", "--outdir", default="freddie_segment/")
    sg.add_argument("-t", "--threads", type=int, default=1)
    sg.add_argument("-sd", "--sigma", type=float, default=5.0)
    sg.add_argument("-tp", "--threshold-rate", type=float, default=0.90)
    sg.add_argument("-vf", "--variance-factor", type=float, default=3.0)
    sg.add_argument("-mps", "--max-problem-size", type=int, default=50)
    sg.add_argument("-lo", "--min-read-support-outside", type=int, default=3)
    sg.add_argument("--no-device", action="store_true", help="solve the DP on the host instead of the accelerator")

    cl = sub.add_parser("cluster", help="exact isoform clustering")
    cl.add_argument("-s", "--segment-dir", required=True)
    cl.add_argument("-rm", "--recycle-model", default="constant",
                    choices=["constant", "exons", "introns", "relative"])
    cl.add_argument("-go", "--gap-offset", type=int, default=20)
    cl.add_argument("-e", "--epsilon", type=float, default=0.2)
    cl.add_argument("-mr", "--max-rounds", type=int, default=30)
    cl.add_argument("-is", "--min-isoform-size", type=int, default=3)
    cl.add_argument("-mi", "--max-ilp", type=int, default=1000)
    cl.add_argument("-to", "--timeout", type=float, default=1.0, help="solver deadline, minutes")
    cl.add_argument("-t", "--threads", type=int, default=1)
    cl.add_argument("-l", "--logs-dir", default=None)
    cl.add_argument("-o", "--outdir", default="freddie_cluster/")

    iso = sub.add_parser("isoforms", help="consensus -> GTF")
    iso.add_argument("-s", "--split-dir", required=True)
    iso.add_argument("-c", "--cluster-dir", required=True)
    iso.add_argument("-m", "--majority-threshold", type=float, default=0.50)
    iso.add_argument("-w", "--correction-window", type=int, default=8)
    iso.add_argument("-t", "--threads", type=int, default=1)
    iso.add_argument("-o", "--output", default="freddie_isoforms.gtf")

    pl = sub.add_parser("pipeline", help="split -> segment -> cluster -> isoforms")
    pl.add_argument("-b", "--bam", required=True)
    pl.add_argument("-r", "--reads", nargs="+", required=True)
    pl.add_argument("-o", "--outdir", required=True)
    pl.add_argument("--config", default=None, help="YAML pipeline config")
    pl.add_argument("--resume", action="store_true")
    pl.add_argument("--protect", action="store_true",
                    help="make completed stage outputs read-only "
                         "(the reference Snakefile's protected())")

    wf = sub.add_parser("workflow", help="multi-sample config-driven run (Snakemake equivalent)")
    wf.add_argument("config", help="workflow YAML (outpath, samples, stages)")
    wf.add_argument("--set", dest="overrides", action="append", default=[],
                    help="dotted-path override, e.g. --set stages.segment.sigma=4.0")
    wf.add_argument("--no-resume", action="store_true")

    plt = sub.add_parser("plot", help="per-isoform PDFs vs annotation")
    plt.add_argument("-a", "--annotation-gtf", required=True)
    plt.add_argument("-s", "--segment-tsv", required=True)
    plt.add_argument("-c", "--cluster-tsv", required=True)
    plt.add_argument("--tints", type=int, nargs="+", default=[])
    plt.add_argument("-od", "--out-dir", default="freddie_plot")
    plt.add_argument("-t", "--threads", type=int, default=1)

    sv = sub.add_parser("segment-vis", help="segmentation-QC pickle")
    sv.add_argument("-s", "--split-tsv", nargs="+", required=True)
    sv.add_argument("-g", "--segment-tsv", nargs="+", required=True)
    sv.add_argument("-a", "--annotation-gtf", required=True)
    sv.add_argument("-o", "--output", default="vis_segmentation.pickle")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .utils.procenv import use_compile_cache

    use_compile_cache()
    if args.command == "split":
        from .stages.split import run_split

        cfg = SplitConfig(
            consider_nonspliced=args.consider_nonspliced,
            contig_min_size=args.contig_min_size,
            threads=args.threads,
        )
        counts = run_split(args.bam, args.reads, args.outdir.rstrip("/"), cfg)
        print(f"[split] {sum(counts.values())} tints over {len(counts)} contigs")
    elif args.command == "segment":
        from .stages.segment import run_segment

        cfg = SegmentConfig(
            consider_ends=args.consider_ends,
            sigma=args.sigma,
            threshold_rate=args.threshold_rate,
            variance_factor=args.variance_factor,
            max_problem_size=args.max_problem_size,
            min_read_support_outside=args.min_read_support_outside,
            threads=args.threads,
            use_device=not args.no_device,
        )
        t0 = time.perf_counter()
        n = run_segment(args.split_dir.rstrip("/"), args.outdir.rstrip("/"), cfg,
                        log=print)
        print(f"[segment] {n} tints in {time.perf_counter() - t0:.2f}s")
    elif args.command == "cluster":
        from .stages.cluster import run_cluster

        cfg = ClusterConfig(
            recycle_model=args.recycle_model,
            gap_offset=args.gap_offset,
            epsilon=args.epsilon,
            max_rounds=args.max_rounds,
            min_isoform_size=args.min_isoform_size,
            max_ilp=args.max_ilp,
            timeout=args.timeout,
            threads=args.threads,
            logs_dir=args.logs_dir,
        )
        n = run_cluster(args.segment_dir.rstrip("/"), args.outdir.rstrip("/"), cfg)
        print(f"[cluster] {n} tints")
    elif args.command == "isoforms":
        from .stages.isoforms import run_isoforms

        cfg = IsoformsConfig(
            majority_threshold=args.majority_threshold,
            correction_window=args.correction_window,
            threads=args.threads,
        )
        n = run_isoforms(
            args.split_dir.rstrip("/"), args.cluster_dir.rstrip("/"), args.output, cfg
        )
        print(f"[isoforms] {n} transcripts -> {args.output}")
    elif args.command == "pipeline":
        from .stages.pipeline import run_pipeline

        cfg = PipelineConfig.from_yaml(args.config) if args.config else PipelineConfig()
        run_pipeline(args.bam, args.reads, args.outdir, cfg,
                     resume=args.resume, protect=args.protect)
    elif args.command == "workflow":
        from .stages.workflow import load_workflow_config, run_workflow

        overrides = {}
        for item in args.overrides:
            key, _, val = item.partition("=")
            try:
                import ast

                overrides[key] = ast.literal_eval(val)
            except (ValueError, SyntaxError):
                overrides[key] = val
        config = load_workflow_config(args.config, overrides)
        run_workflow(config, resume=not args.no_resume)
    elif args.command == "plot":
        from .stages.plot import run_plot

        n = run_plot(
            args.annotation_gtf, args.segment_tsv, args.cluster_tsv,
            args.out_dir.rstrip("/"), tint_ids=frozenset(args.tints),
            threads=args.threads,
        )
        print(f"[plot] {n} PDFs")
    elif args.command == "segment-vis":
        from .stages.segment_vis import run_segment_vis

        run_segment_vis(args.split_tsv, args.segment_tsv, args.annotation_gtf, args.output)
        print(f"[segment-vis] -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
