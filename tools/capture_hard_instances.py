#!/usr/bin/env python3
"""Capture the cluster stage's hardest solver instances as a pickle corpus.

Builds the bench dataset (bench.py's SIM), runs split + segment on the CPU
backend, then runs every tint's clustering with the production solver while
recording each ClusterInstance whose solve exceeds --slow-s (or that ends
non-OPTIMAL). The corpus feeds solver-bound experiments
(tools/solver_experiment.py) so prunes can be evaluated offline without
re-running the pipeline.

Usage: python tools/capture_hard_instances.py [--workdir DIR] [--slow-s S]
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/freddie_hard")
    ap.add_argument("--slow-s", type=float, default=1.0)
    ap.add_argument("--timeout-min", type=float, default=0.25)
    ap.add_argument("--genes", type=int, default=0,
                    help="override SIM n_genes (e.g. 1000 reproduces the "
                         "~300k-read scale run where the dense instances live)")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    os.makedirs(args.workdir, exist_ok=True)
    sys.path.insert(0, REPO)
    import bench

    if args.genes:
        bench.SIM = dict(bench.SIM, n_genes=args.genes)

    split_dir = os.path.join(args.workdir, "split")
    seg_dir = os.path.join(args.workdir, "segment")
    if not os.path.isdir(seg_dir):
        bam, fq, n_reads, _, _ = bench.build_dataset(args.workdir)
        print(f"[capture] {n_reads} reads simulated")
        from freddie_jax.config import SegmentConfig, SplitConfig
        from freddie_jax.stages.segment import run_segment
        from freddie_jax.stages.split import run_split

        run_split(bam, [fq], split_dir, SplitConfig(threads=2))
        run_segment(split_dir, seg_dir, SegmentConfig(threads=4))
        print("[capture] split+segment done")

    from freddie_jax.config import ClusterConfig
    from freddie_jax.io.tsv import parse_segment_tsv
    from freddie_jax.stages import cluster as cl

    corpus = []
    orig_solve = cl._solve

    def timed_solve(inst, deadline_s):
        t0 = time.perf_counter()
        res = orig_solve(inst, deadline_s)
        dt = time.perf_counter() - t0
        if dt > args.slow_s or res.status != "OPTIMAL":
            corpus.append(
                dict(
                    inst=inst,
                    dt=dt,
                    status=res.status,
                    objective=res.objective,
                    assigned=res.assigned,
                    n=len(inst.rows),
                    mi=len(inst.seg_len),
                    n_incomp=len(inst.incomp),
                )
            )
            print(
                f"[capture] hard: N={len(inst.rows)} Mi={len(inst.seg_len)} "
                f"incomp={len(inst.incomp)} dt={dt:.2f}s {res.status}"
            )
        return res

    cl._solve = timed_solve
    cfg = ClusterConfig(threads=1, timeout=args.timeout_min)
    t0 = time.perf_counter()
    n_tints = 0
    for contig in sorted(os.listdir(seg_dir)):
        cdir = os.path.join(seg_dir, contig)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if not (fn.startswith("segment_") and fn.endswith(".tsv")):
                continue
            tint = parse_segment_tsv(os.path.join(cdir, fn))
            cl.cluster_tint(tint, cfg)
            n_tints += 1
    wall = time.perf_counter() - t0
    out = os.path.join(args.workdir, "hard_instances.pkl")
    with open(out, "wb") as f:
        pickle.dump(corpus, f)
    n_to = sum(1 for c in corpus if c["status"] != "OPTIMAL")
    print(
        f"[capture] {n_tints} tints in {wall:.1f}s; {len(corpus)} hard instances "
        f"({n_to} non-OPTIMAL) -> {out}"
    )


if __name__ == "__main__":
    main()
