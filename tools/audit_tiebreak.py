#!/usr/bin/env python3
"""Measure how often cluster ILP instances have non-unique optima.

Runs the parity suite's three simulation configs across seed shifts,
drives split -> segment -> cluster, and classifies every solver instance
produced by the production rounds loop with solver.audit.audit_instance.
An instance is 'nonunique' when two distinct (isoform, assignment) pairs
attain the optimal objective -- the only regime where our canonical
tie-break could legitimately differ from Gurobi's (PARITY.md deviation 1).

Usage: python tools/audit_tiebreak.py [n_seed_shifts]
"""

from __future__ import annotations

import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from freddie_jax.config import ClusterConfig, SegmentConfig, SplitConfig  # noqa: E402
from freddie_jax.io.tsv import parse_segment_tsv  # noqa: E402
from freddie_jax.solver.audit import audit_instance  # noqa: E402
from freddie_jax.stages.cluster import cluster_tint  # noqa: E402
from freddie_jax.stages.segment import run_segment  # noqa: E402
from freddie_jax.stages.split import run_split  # noqa: E402
from freddie_jax.utils.sim import simulate  # noqa: E402

CONFIGS = {
    "clean": dict(
        n_genes=3, isoforms_per_gene=2, reads_per_isoform=8,
        minus_strand_genes=True, truncate_prob=0.25, tail_prob=0.85,
    ),
    "noisy": dict(
        n_genes=2, isoforms_per_gene=4, reads_per_isoform=30,
        minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8,
        end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6,
        big_del_rate=0.06,
    ),
    "gnarly": dict(
        n_genes=2, isoforms_per_gene=5, reads_per_isoform=25,
        exons_per_gene=7, minus_strand_genes=True, truncate_prob=0.3,
        tail_prob=0.7, end_jitter=30, indel_rate=0.15, alt_splice=True,
        junction_jitter=8, big_del_rate=0.1,
    ),
}
BASE_SEEDS = {"clean": 2024, "noisy": 4096, "gnarly": 8192}


def audit_config(name: str, seed: int, stats: dict) -> None:
    with tempfile.TemporaryDirectory() as d:
        sim = simulate(seed=seed, **CONFIGS[name])
        bam, fq = os.path.join(d, "r.bam"), os.path.join(d, "r.fastq")
        sim.write_bam(bam)
        sim.write_fastq(fq)
        split_dir = os.path.join(d, "split")
        counts = run_split(bam, [fq], split_dir, SplitConfig())
        seg_dir = os.path.join(d, "segment")
        run_segment(split_dir, seg_dir, SegmentConfig())
        cfg = ClusterConfig()
        for contig, n in counts.items():
            for t in range(n):
                path = os.path.join(seg_dir, contig, f"segment_{contig}_{t}.tsv")
                tint = parse_segment_tsv(path)

                def hook(inst):
                    # Offline budget knobs: the default interactive budget
                    # (30 s / 2M nodes) classifies all but the very
                    # hardest instances; FREDDIE_AUDIT_DEADLINE_S /
                    # FREDDIE_AUDIT_NODE_CAP raise it for the tail.
                    verdict = audit_instance(
                        inst,
                        deadline_s=float(
                            os.environ.get("FREDDIE_AUDIT_DEADLINE_S", "30")
                        ),
                        node_cap=int(
                            os.environ.get("FREDDIE_AUDIT_NODE_CAP", "2000000")
                        ),
                    )
                    stats[verdict] = stats.get(verdict, 0) + 1
                    stats.setdefault("sizes", []).append(
                        (len(inst.rows), len(inst.seg_len))
                    )

                cluster_tint(tint, cfg, instance_hook=hook)


def main():
    shifts = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    stats: dict = {}
    for shift in range(shifts):
        for name, base in BASE_SEEDS.items():
            audit_config(name, base + shift, stats)
            counts = {k: v for k, v in stats.items() if k != "sizes"}
            print(f"[{name} shift={shift}] cumulative: "
                  f"{sum(counts.values())} instances, {counts}", flush=True)
    sizes = stats.pop("sizes", [])
    total = sum(stats.values())
    if sizes:
        import numpy as np

        ns = np.array([s[0] for s in sizes])
        ms = np.array([s[1] for s in sizes])
        print(f"instance sizes: N median={np.median(ns):.0f} max={ns.max()}, "
              f"Mi median={np.median(ms):.0f} max={ms.max()}")
    nonu = stats.get("nonunique", 0)
    print(f"TOTAL {total} instances: {stats} "
          f"-> nonunique rate {nonu / max(total, 1):.3%}")


if __name__ == "__main__":
    main()
