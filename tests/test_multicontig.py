"""Multi-contig BAMs: the single-pass reader groups records per contig and
each contig yields its own tints and GTF records."""

import random

from freddie_jax.config import PipelineConfig
from freddie_jax.io.bam import BamRecord, BamWriter, FLAG_REVERSE
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.sim import (
    Simulation,
    make_gene,
    make_isoforms,
    random_genome,
    simulate_read,
)


def test_two_contigs_end_to_end(tmp_path):
    rng = random.Random(5)
    sims = []
    for ci, contig in enumerate(("chr1", "chr2")):
        sim = Simulation(
            contig=contig, contig_len=2_000_000,
            genome=random_genome(2_000_000, rng), transcripts=[],
        )
        exons = make_gene(rng, contig, 10_000, 4)
        for tr in make_isoforms(rng, exons, 2, contig, ci):
            sim.transcripts.append(tr)
            for i in range(6):
                sim.reads.append(simulate_read(rng, sim, tr, i))
        sims.append(sim)

    bam = str(tmp_path / "r.bam")
    with BamWriter(bam, ["chr1", "chr2"], [2_000_000, 2_000_000]) as w:
        for ci, sim in enumerate(sims):
            for r in sorted(sim.reads, key=lambda r: r.pos):
                w.write(
                    BamRecord(
                        query_name=f"{r.name}.c{ci}",
                        flag=FLAG_REVERSE if r.strand == "-" else 0,
                        reference_id=ci,
                        reference_start=r.pos,
                        mapq=60,
                        cigartuples=r.cigar,
                        query_sequence=r.aligned_seq,
                    )
                )
    fq = str(tmp_path / "r.fastq")
    with open(fq, "w") as f:
        for ci, sim in enumerate(sims):
            for r in sim.reads:
                f.write(f"@{r.name}.c{ci}\n{r.fastq_seq}\n+\n{'I' * len(r.fastq_seq)}\n")

    out = str(tmp_path / "out")
    stats = run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    assert stats["split"]["result"] == {"chr1": 1, "chr2": 1}
    gtf = open(f"{out}/isoforms.gtf").read().splitlines()
    chroms = {l.split("\t")[0] for l in gtf}
    assert chroms == {"chr1", "chr2"}
    # GTF is globally sorted by (chrom, start)
    keys = [
        (l.split("\t")[0], int(l.split("\t")[3]))
        for l in gtf
        if l.split("\t")[2] == "transcript"
    ]
    assert keys == sorted(keys)
    # all four simulated structures recovered
    want = {tuple(tr.exons) for s in sims for tr in s.transcripts}
    got = set()
    cur, prev = [], None
    for l in gtf:
        f = l.split("\t")
        if f[2] == "transcript":
            if cur:
                got.add(tuple(cur))
            cur = []
        else:
            cur.append((int(f[3]), int(f[4])))
    if cur:
        got.add(tuple(cur))
    assert want == got
