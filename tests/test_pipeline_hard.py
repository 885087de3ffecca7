"""Harder end-to-end scenarios: minus-strand genes (polyT leading tails ->
'S' tail category -> '-' strand calls), truncated reads, tail-less reads."""

import os

from freddie_jax.config import PipelineConfig
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.sim import simulate
from tests.test_pipeline import parse_gtf


def run(sim, tmp_path, tag):
    bam, fq = str(tmp_path / f"{tag}.bam"), str(tmp_path / f"{tag}.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(tmp_path / f"out_{tag}")
    run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    return parse_gtf(os.path.join(out, "isoforms.gtf"))


def test_minus_strand_genes(tmp_path):
    sim = simulate(
        seed=21, n_genes=2, isoforms_per_gene=1, reads_per_isoform=10,
        minus_strand_genes=True,
    )
    got = run(sim, tmp_path, "minus")
    by_exons = {tuple(tuple(e) for e in t["exons"]): t for t in got.values()}
    for tr in sim.transcripts:
        key = tuple(tuple(e) for e in tr.exons)
        assert key in by_exons, f"missing {tr.name}"
        assert by_exons[key]["strand"] == tr.strand, (
            tr.name, tr.strand, by_exons[key]["strand"],
        )


def test_truncated_and_tailless_reads(tmp_path):
    sim = simulate(
        seed=22, n_genes=2, isoforms_per_gene=2, reads_per_isoform=12,
        truncate_prob=0.3, tail_prob=0.8,
    )
    got = run(sim, tmp_path, "trunc")
    # With truncations/tail dropouts, full-length isoform structures must
    # still be recovered (the reference corrects truncated reads into the
    # full isoform via the C matrix).
    got_exons = {tuple(tuple(e) for e in t["exons"]) for t in got.values()}
    want = {tuple(tr.exons) for tr in sim.transcripts}
    missing = want - got_exons
    assert not missing, f"missing isoforms: {missing}"


def test_single_exon_reads_skipped(tmp_path):
    # Nonspliced reads are dropped by default (consider_nonspliced=False):
    # a gene whose isoform has one exon produces no tint.
    sim = simulate(seed=23, n_genes=1, isoforms_per_gene=1, reads_per_isoform=8,
                   exons_per_gene=1)
    bam, fq = str(tmp_path / "se.bam"), str(tmp_path / "se.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(tmp_path / "out_se")
    run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    assert open(os.path.join(out, "isoforms.gtf")).read() == ""
