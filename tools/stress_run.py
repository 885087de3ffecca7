#!/usr/bin/env python3
"""Large-corpus stress harness: generate a multi-contig simulated corpus
and run the pipeline stage by stage with walls + peak-RSS reporting.

Replaces the ad-hoc /tmp drivers used for the 300k/1M/3M/10M rows in
BENCH_NOTES.md with a durable recipe.

  python tools/stress_run.py gen  --out DIR --contigs 4 --genes 9250
  python tools/stress_run.py run  --corpus DIR [--threads N] [--window W]

`gen` builds one sim per contig (bench.SIM noise profile, per-contig
seeds, read names uniquified by contig), writes per-contig BAMs, then
merges them into ONE coordinate-sorted multi-contig BAM + FASTQ via the
in-repo codec. Each contig is ~543 Mb at 9250 genes (the realistic
layout: a single >2 Gb contig exceeds the BAM bin scheme / int32
positions). 9250 genes x 3 isoforms x 90 reads x 4 contigs = 9,990,000
reads. Generation is run in its own process so its RSS does not pollute
the pipeline measurement.

`run` executes split -> segment -> cluster -> isoforms in-process,
prints per-stage walls, total, reads/s, transcript count, and the
process peak RSS (VmHWM). --window sets SegmentConfig.stream_window
(the 100M-scale memory bound; 0 = off).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# bench.SIM noise profile (kept in sync by importing bench).
SIM_NOISE = dict(
    isoforms_per_gene=3, reads_per_isoform=90,
    minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8,
    end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6,
    big_del_rate=0.06,
)


def cmd_gen(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from freddie_jax.io.bam import BamReader, BamRecord, BamWriter
    from freddie_jax.utils.sim import simulate

    os.makedirs(args.out, exist_ok=True)
    fq_path = os.path.join(args.out, "stress.fastq")
    contig_bams, contigs, lengths = [], [], []
    with open(fq_path, "w") as fq:
        for i in range(args.contigs):
            contig = f"chr{i + 1}"
            t0 = time.time()
            sim = simulate(seed=args.seed + i, contig=contig,
                           n_genes=args.genes, **SIM_NOISE)
            for r in sim.reads:  # uniquify across contigs
                r.name = f"{contig}_{r.name}"
            cb = os.path.join(args.out, f"_{contig}.bam")
            sim.write_bam(cb)
            for r in sim.reads:
                fq.write(f"@{r.name}\n{r.fastq_seq}\n+\n{'I' * len(r.fastq_seq)}\n")
            contig_bams.append(cb)
            contigs.append(contig)
            lengths.append(sim.contig_len)
            print(f"[gen] {contig}: {len(sim.reads)} reads, "
                  f"{sim.contig_len / 1e6:.0f} Mb, {time.time() - t0:.0f}s",
                  flush=True)
            del sim
    # Merge: per-contig BAMs are each coordinate-sorted; concatenating
    # them in header order yields a coordinate-sorted multi-contig BAM.
    merged = os.path.join(args.out, "stress.bam")
    t0 = time.time()
    n = 0
    with BamWriter(merged, contigs, lengths) as w:
        for i, cb in enumerate(contig_bams):
            with BamReader(cb) as rd:
                for rec in rd:
                    w.write(BamRecord(
                        query_name=rec.query_name, flag=rec.flag,
                        reference_id=i, reference_start=rec.reference_start,
                        mapq=rec.mapq, cigartuples=rec.cigartuples,
                        query_sequence=rec.query_sequence,
                    ))
                    n += 1
            os.remove(cb)
    print(f"[gen] merged {n} records over {len(contigs)} contigs "
          f"in {time.time() - t0:.0f}s -> {merged}", flush=True)


def _vmhwm_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM:"):
                return int(line.split()[1]) / 1e6  # kB -> GB
    return float("nan")


def cmd_run(args):
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import dataclasses

    from freddie_jax.config import PipelineConfig
    from freddie_jax.stages.cluster import run_cluster
    from freddie_jax.stages.isoforms import run_isoforms
    from freddie_jax.stages.segment import run_segment
    from freddie_jax.stages.split import run_split

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        split=dataclasses.replace(cfg.split, threads=args.threads),
        segment=dataclasses.replace(
            cfg.segment, threads=args.threads, stream_window=args.window),
        cluster=dataclasses.replace(cfg.cluster, threads=args.threads),
        isoforms=dataclasses.replace(cfg.isoforms, threads=args.threads),
    )
    bam = os.path.join(args.corpus, "stress.bam")
    fq = os.path.join(args.corpus, "stress.fastq")
    out = args.workdir or os.path.join(args.corpus, "out")
    walls = {}
    t0 = time.perf_counter()
    run_split(bam, [fq], os.path.join(out, "split"), cfg.split)
    walls["split"] = round(time.perf_counter() - t0, 1)
    n_reads = sum(1 for _ in open(fq)) // 4  # untimed
    t0 = time.perf_counter()
    run_segment(os.path.join(out, "split"), os.path.join(out, "segment"),
                cfg.segment)
    walls["segment"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    run_cluster(os.path.join(out, "segment"), os.path.join(out, "cluster"),
                cfg.cluster)
    walls["cluster"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    run_isoforms(os.path.join(out, "split"), os.path.join(out, "cluster"),
                 os.path.join(out, "isoforms.gtf"), cfg.isoforms)
    walls["isoforms"] = round(time.perf_counter() - t0, 1)
    total = sum(walls.values())
    n_tx = sum(1 for line in open(os.path.join(out, "isoforms.gtf"))
               if "\ttranscript\t" in line)
    print(json.dumps(dict(
        walls=walls, total_s=round(total, 1),
        reads=n_reads,
        reads_per_s=round((n_reads or 0) / total),
        transcripts=n_tx,
        peak_rss_gb=round(_vmhwm_gb(), 2),
        threads=args.threads, window=args.window,
    )), flush=True)


def main():
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gen")
    g.add_argument("--out", required=True)
    g.add_argument("--contigs", type=int, default=4)
    g.add_argument("--genes", type=int, default=9250)
    g.add_argument("--seed", type=int, default=77_000)
    g.set_defaults(fn=cmd_gen)
    r = sub.add_parser("run")
    r.add_argument("--corpus", required=True)
    r.add_argument("--workdir", default=None)
    r.add_argument("--threads", type=int, default=os.cpu_count() or 4)
    r.add_argument("--window", type=int, default=0)
    r.add_argument("--cpu", action="store_true", default=True)
    r.set_defaults(fn=cmd_run)
    args = ap.parse_args()
    args.fn(args)


if __name__ == "__main__":
    main()
