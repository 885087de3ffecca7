#!/usr/bin/env python3
"""Worked example: simulate Nanopore-style reads and run the full pipeline.

    python examples/simulate_and_run.py out_dir/

Produces out_dir/{reads.bam,reads.fastq,annotation.gtf} and the pipeline
outputs under out_dir/run/ (per-stage TSV directories + isoforms.gtf),
then prints a truth-vs-output summary. With real data, skip the
simulation and point the CLI at your sorted BAM + FASTQ:

    python -m freddie_jax.cli pipeline -b reads.sorted.bam -r reads.fastq -o out/
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from freddie_jax import PipelineConfig, run_pipeline
from freddie_jax.utils.sim import simulate


def main(outdir: str) -> None:
    os.makedirs(outdir, exist_ok=True)
    sim = simulate(
        seed=7, n_genes=5, isoforms_per_gene=3, reads_per_isoform=20,
        minus_strand_genes=True, alt_splice=True, truncate_prob=0.15,
    )
    bam = os.path.join(outdir, "reads.bam")
    fastq = os.path.join(outdir, "reads.fastq")
    annot = os.path.join(outdir, "annotation.gtf")
    sim.write_bam(bam)
    sim.write_fastq(fastq)
    sim.write_annotation_gtf(annot)
    print(f"simulated {len(sim.reads)} reads / {len(sim.transcripts)} transcripts")

    run_dir = os.path.join(outdir, "run")
    run_pipeline(bam, [fastq], run_dir, PipelineConfig())

    gtf = os.path.join(run_dir, "isoforms.gtf")
    found = sum(1 for line in open(gtf) if line.split("\t")[2] == "transcript")
    want = {tuple(tr.exons) for tr in sim.transcripts}
    got = set()
    cur = []
    tid = None
    for line in open(gtf):
        f = line.rstrip("\n").split("\t")
        t = f[8].split('transcript_id "')[1].split('"')[0]
        if f[2] == "transcript":
            if cur:
                got.add(tuple(cur))
            cur = []
            tid = t
        elif f[2] == "exon":
            cur.append((int(f[3]), int(f[4])))
    if cur:
        got.add(tuple(cur))
    print(f"reported {found} transcripts; {len(want & got)}/{len(want)} "
          f"simulated structures recovered exactly")
    print(f"GTF: {gtf}")


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else "example_out"
    if out.startswith("-"):
        sys.exit(f"usage: {sys.argv[0]} [out_dir]  (got flag-like arg {out!r})")
    main(out)
