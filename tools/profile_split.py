#!/usr/bin/env python3
"""Profile the split stage on a large simulated dataset.

Usage: python tools/profile_split.py [n_genes] [reads_per_isoform]
Prints a cProfile top-30 by cumulative time plus wall-clock per phase.
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

jax.config.update("jax_platforms", "cpu")

from freddie_jax.utils.sim import simulate
from freddie_jax.config import SplitConfig
from freddie_jax.stages.split import run_split


def main():
    n_genes = int(sys.argv[1]) if len(sys.argv) > 1 else 400
    rpi = int(sys.argv[2]) if len(sys.argv) > 2 else 250
    workdir = tempfile.mkdtemp(prefix="freddie_prof_split_")
    t0 = time.perf_counter()
    sim = simulate(
        seed=4242, n_genes=n_genes, isoforms_per_gene=3, reads_per_isoform=rpi,
        minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8,
        end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6,
        big_del_rate=0.06,
    )
    bam = os.path.join(workdir, "prof.bam")
    fq = os.path.join(workdir, "prof.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    n_reads = len(sim.reads)
    print(f"[sim] {n_reads} reads in {time.perf_counter()-t0:.1f}s -> {workdir}")

    split_dir = os.path.join(workdir, "split")
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    counts = run_split(bam, [fq], split_dir, SplitConfig(threads=1))
    prof.disable()
    dt = time.perf_counter() - t0
    print(f"[split] {sum(counts.values())} tints, {dt:.2f}s, {n_reads/dt:.0f} reads/s")
    stats = pstats.Stats(prof)
    stats.sort_stats("cumulative").print_stats(30)


if __name__ == "__main__":
    main()
