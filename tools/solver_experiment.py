#!/usr/bin/env python3
"""Replay the captured hard-instance corpus through the production solver.

Compares wall time and status against the capture run's recorded results
and asserts result identity (objective/assignment) for instances both runs
solved to OPTIMAL -- the guardrail for bound/prune experiments.

Usage: python tools/solver_experiment.py [--corpus PKL] [--timeout-min M]
       [--engine two_phase|exact_native|exact_py]
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
    ap.add_argument("--corpus", default="/tmp/freddie_hard/hard_instances.pkl")
    ap.add_argument("--timeout-min", type=float, default=0.25)
    ap.add_argument("--engine", default="two_phase")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")

    with open(args.corpus, "rb") as f:
        corpus = pickle.load(f)

    from freddie_jax.solver.exact import solve_exact
    from freddie_jax.solver.native import solve_exact_native
    from freddie_jax.solver.two_phase import solve_two_phase

    engines = dict(
        two_phase=solve_two_phase,
        exact_native=lambda inst, d: solve_exact_native(inst, d),
        exact_py=lambda inst, d: solve_exact(inst, d),
    )
    solve = engines[args.engine]
    deadline = args.timeout_min * 60.0

    total_old = total_new = 0.0
    to_old = to_new = 0
    mismatches = 0
    for i, rec in enumerate(corpus):
        t0 = time.perf_counter()
        res = solve(rec["inst"], deadline)
        dt = time.perf_counter() - t0
        total_old += rec["dt"]
        total_new += dt
        to_old += rec["status"] != "OPTIMAL"
        to_new += res.status != "OPTIMAL"
        tag = ""
        if rec["status"] == "OPTIMAL" and res.status == "OPTIMAL":
            if res.objective != rec["objective"] or res.assigned != rec["assigned"]:
                tag = "  << RESULT MISMATCH"
                mismatches += 1
        print(
            f"[{i:3d}] N={rec['n']:4d} Mi={rec['mi']:3d} inc={rec['n_incomp']:6d} "
            f"{rec['status']:8s}{rec['dt']:7.2f}s -> {res.status:8s}{dt:7.2f}s{tag}"
        )
    print(
        f"\nwall {total_old:.1f}s -> {total_new:.1f}s; "
        f"non-OPTIMAL {to_old} -> {to_new}; result mismatches {mismatches}"
    )
    if mismatches:
        sys.exit(1)


if __name__ == "__main__":
    main()
