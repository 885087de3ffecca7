#!/usr/bin/env python3
"""cProfile the production segment stage on the bench corpus (CPU backend).

Builds the bench dataset (bench.SIM), runs split, then profiles
run_segment to show where phase A/C host time goes. Usage:
    python tools/profile_segment.py [--device] [--sort cumtime] [--lines N]
"""
import cProfile
import os
import pstats
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

if "--device" not in sys.argv:
    jax.config.update("jax_platforms", "cpu")

from freddie_jax.utils.procenv import use_compile_cache  # noqa: E402

use_compile_cache()

from bench import SIM, build_dataset, run_split_stage  # noqa: E402
from freddie_jax.config import SegmentConfig  # noqa: E402
from freddie_jax.stages.segment import run_segment  # noqa: E402


def main():
    workdir = tempfile.mkdtemp(prefix="freddie_prof_")
    bam, fq, n_reads, _truth, _r = build_dataset(workdir)
    split_dir, n_tints, split_dt = run_split_stage(bam, fq, workdir)
    print(f"[prof] {n_reads} reads / {n_tints} tints; split {split_dt:.2f}s",
          file=sys.stderr)
    cfg = SegmentConfig(threads=4)
    # Warm run (compiles + caches)
    t0 = time.perf_counter()
    run_segment(split_dir, os.path.join(workdir, "seg_warm"), cfg)
    print(f"[prof] warm run {time.perf_counter()-t0:.2f}s", file=sys.stderr)

    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    run_segment(split_dir, os.path.join(workdir, "seg_prof"), cfg)
    prof.disable()
    dt = time.perf_counter() - t0
    print(f"[prof] profiled run {dt:.2f}s ({n_reads/dt:.0f} reads/s)",
          file=sys.stderr)
    sort = "cumtime"
    if "--sort" in sys.argv:
        sort = sys.argv[sys.argv.index("--sort") + 1]
    lines = 45
    if "--lines" in sys.argv:
        lines = int(sys.argv[sys.argv.index("--lines") + 1])
    stats = pstats.Stats(prof, stream=sys.stdout)
    stats.sort_stats(sort).print_stats(lines)


if __name__ == "__main__":
    main()
