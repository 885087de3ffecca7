#!/usr/bin/env python3
"""Fine-grained wall-time breakdown of the cluster stage.

Monkey-patches timing wrappers around the stage's components (TSV parse,
preprocess/partition packaging, instance build, and each solver engine /
escalation rung) and runs the production single-thread path over an
existing segment directory. Prints a per-component table plus the
distribution of per-instance solve times and escalations taken.

Usage: python tools/profile_cluster.py --segment-dir DIR [--timeout-min M]
       [--limit N]  (limit = only the first N tints, for quick runs)
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter, defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ACC = defaultdict(float)
CNT = Counter()
SOLVES = []  # (dt, status, N, Mi, n_incomp)


def timed(name, fn):
    def wrap(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        ACC[name] += time.perf_counter() - t0
        CNT[name] += 1
        return out

    return wrap


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--segment-dir", required=True)
    ap.add_argument("--timeout-min", type=float, default=1.0)
    ap.add_argument("--limit", type=int, default=0)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    import freddie_jax.io.tsv as tsv
    import freddie_jax.solver.lp_bound as lpb
    import freddie_jax.solver.native as nat
    import freddie_jax.solver.segenum as se
    import freddie_jax.solver.two_phase as tp
    from freddie_jax.config import ClusterConfig
    from freddie_jax.stages import cluster as cl

    tsv.parse_segment_tsv = timed("parse", tsv.parse_segment_tsv)
    cl.parse_segment_tsv = tsv.parse_segment_tsv
    cl.preprocess = timed("preprocess", cl.preprocess)
    cl.partition_reads = timed("partition", cl.partition_reads)
    cl.build_instance = timed("build_instance", cl.build_instance)

    # Solver rungs. two_phase imports names at call time from .segenum /
    # .native / .lp_bound, so patch the modules.
    orig_raw = tp._solve_raw

    def raw(inst, deadline_s, node_budget=0):
        name = "solve.phase1" if node_budget else "solve.full_dfs"
        t0 = time.perf_counter()
        out = orig_raw(inst, deadline_s, node_budget)
        ACC[name] += time.perf_counter() - t0
        CNT[name] += 1
        return out

    tp._solve_raw = raw
    se.solve_segment_enum_closure = timed("solve.closure", se.solve_segment_enum_closure)
    se.solve_segment_enum = timed("solve.segenum", se.solve_segment_enum)
    se.solve_segment_enum_wide = timed("solve.wide", se.solve_segment_enum_wide)
    lpb.lp_lower_bound = timed("solve.lp", lpb.lp_lower_bound)
    # Inside the closure path: time the list replay (native DFS) and the
    # closure/bound construction separately.
    nat.solve_segenum_list_native = timed("closure.replay", nat.solve_segenum_list_native)
    se.solve_segenum_list_native = nat.solve_segenum_list_native

    orig_solve = cl._solve

    def solve(inst, deadline_s):
        t0 = time.perf_counter()
        res = orig_solve(inst, deadline_s)
        dt = time.perf_counter() - t0
        SOLVES.append((dt, res.status, len(inst.rows), len(inst.seg_len),
                       len(inst.incomp)))
        return res

    cl._solve = solve

    cfg = ClusterConfig(timeout=args.timeout_min, threads=1)
    jobs = []
    for contig in sorted(os.listdir(args.segment_dir)):
        cdir = os.path.join(args.segment_dir, contig)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if fn.startswith("segment_") and fn.endswith(".tsv"):
                jobs.append(os.path.join(cdir, fn))
    if args.limit:
        jobs = jobs[: args.limit]

    t0 = time.perf_counter()
    for path in jobs:
        tint = tsv.parse_segment_tsv(path)
        t1 = time.perf_counter()
        cl.cluster_tint(tint, cfg)
        ACC["cluster_tint.total"] += time.perf_counter() - t1
    wall = time.perf_counter() - t0

    print(f"\n=== cluster profile: {len(jobs)} tints, wall {wall:.1f}s ===")
    for name in sorted(ACC, key=lambda n: -ACC[n]):
        print(f"  {name:24s} {ACC[name]:8.2f}s  x{CNT[name]}")
    solve_total = sum(s[0] for s in SOLVES)
    print(f"\n  instances: {len(SOLVES)}, solve total {solve_total:.1f}s")
    by_status = Counter(s[1] for s in SOLVES)
    print(f"  statuses: {dict(by_status)}")
    SOLVES.sort(reverse=True)
    top = SOLVES[:20]
    top_sum = sum(s[0] for s in SOLVES[:100])
    print(f"  top-100 share: {top_sum / max(solve_total, 1e-9):.2f}")
    print("  top-20 (dt, status, N, Mi, n_incomp):")
    for s in top:
        print(f"    {s[0]:7.2f}s {s[1]:8s} N={s[2]:4d} Mi={s[3]:3d} inc={s[4]}")


if __name__ == "__main__":
    main()
