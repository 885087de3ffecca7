"""End-to-end pipeline test on simulated reads: the output GTF must recover
exactly the simulated isoform structures (error-free reads, so the expected
exon boundaries are the simulation's own)."""

import os

import pytest

from freddie_jax.config import PipelineConfig
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.sim import simulate


def parse_gtf(path):
    transcripts = {}
    for line in open(path):
        f = line.rstrip("\n").split("\t")
        attrs = f[8]
        tid = attrs.split('transcript_id "')[1].split('"')[0]
        if f[2] == "transcript":
            transcripts[tid] = dict(
                chrom=f[0], start=int(f[3]), end=int(f[4]), strand=f[6], exons=[]
            )
        elif f[2] == "exon":
            transcripts[tid]["exons"].append((int(f[3]), int(f[4])))
    return transcripts


@pytest.fixture(scope="module")
def pipeline_out(tmp_path_factory):
    d = tmp_path_factory.mktemp("e2e")
    sim = simulate(seed=5, n_genes=2, isoforms_per_gene=2, reads_per_isoform=10)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(d / "out")
    stats = run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    return sim, out, stats


def test_pipeline_runs_all_stages(pipeline_out):
    sim, out, stats = pipeline_out
    for stage in ("split", "segment", "cluster", "isoforms"):
        assert stage in stats
    assert os.path.exists(os.path.join(out, "isoforms.gtf"))


def test_gtf_recovers_simulated_isoforms(pipeline_out):
    sim, out, stats = pipeline_out
    got = parse_gtf(os.path.join(out, "isoforms.gtf"))
    # Expected: each simulated transcript, as its exon set. GTF exon lines
    # use the raw 0-based start (reference quirk at
    # py/freddie_isoforms.py:108), so truth exons (s, e) appear as (s, e).
    want = {tuple(tr.exons) for tr in sim.transcripts}
    got_exons = {tuple(tuple(x) for x in t["exons"]) for t in got.values()}
    missing = want - got_exons
    extra = got_exons - want
    assert not missing, f"missing isoforms: {missing}"
    assert not extra, f"spurious isoforms: {extra}"
    # every transcript has read support recorded and a strand
    for t in got.values():
        assert t["strand"] in "+-"


def test_pipeline_deterministic(tmp_path):
    sim = simulate(seed=9, n_genes=1, isoforms_per_gene=2, reads_per_isoform=6)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    outs = []
    for run in range(2):
        out = str(tmp_path / f"out{run}")
        run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
        outs.append(open(os.path.join(out, "isoforms.gtf")).read())
    assert outs[0] == outs[1]


def test_cluster_process_pool_byte_identical(tmp_path, monkeypatch):
    """cluster -t N with the size gate forced open (spawn process pool,
    biggest-first scheduling) == serial, byte for byte, per tint file."""
    import filecmp

    from freddie_jax.config import ClusterConfig, SegmentConfig, SplitConfig
    from freddie_jax.stages import cluster as cl
    from freddie_jax.stages.segment import run_segment
    from freddie_jax.stages.split import run_split
    from freddie_jax.utils.sim import simulate

    sim = simulate(seed=31, n_genes=4, isoforms_per_gene=2, reads_per_isoform=8,
                   minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    run_split(bam, [fq], str(tmp_path / "split"), SplitConfig())
    run_segment(str(tmp_path / "split"), str(tmp_path / "segment"), SegmentConfig())
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    n1 = cl.run_cluster(str(tmp_path / "segment"), a, ClusterConfig())
    monkeypatch.setattr(cl, "POOL_MIN_BYTES", 0)
    n2 = cl.run_cluster(str(tmp_path / "segment"), b, ClusterConfig(threads=2))
    assert n1 == n2 > 0
    matched = 0
    for contig in os.listdir(a):
        for fn in os.listdir(os.path.join(a, contig)):
            assert filecmp.cmp(os.path.join(a, contig, fn),
                               os.path.join(b, contig, fn), shallow=False), fn
            matched += 1
    assert matched == n1


def test_isoforms_process_pool_byte_identical(tmp_path):
    """isoforms -t N (process pool over tints) == serial, byte for byte."""
    import filecmp

    from freddie_jax.config import (ClusterConfig, IsoformsConfig,
                                    SegmentConfig, SplitConfig)
    from freddie_jax.stages.cluster import run_cluster
    from freddie_jax.stages.isoforms import run_isoforms
    from freddie_jax.stages.segment import run_segment
    from freddie_jax.stages.split import run_split
    from freddie_jax.utils.sim import simulate

    sim = simulate(seed=29, n_genes=4, isoforms_per_gene=2, reads_per_isoform=8,
                   minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    run_split(bam, [fq], str(tmp_path / "split"), SplitConfig())
    run_segment(str(tmp_path / "split"), str(tmp_path / "segment"), SegmentConfig())
    run_cluster(str(tmp_path / "segment"), str(tmp_path / "cluster"), ClusterConfig())
    a, b = str(tmp_path / "a.gtf"), str(tmp_path / "b.gtf")
    n1 = run_isoforms(str(tmp_path / "split"), str(tmp_path / "cluster"), a,
                      IsoformsConfig())
    n2 = run_isoforms(str(tmp_path / "split"), str(tmp_path / "cluster"), b,
                      IsoformsConfig(threads=2))
    assert n1 == n2 > 0
    assert filecmp.cmp(a, b, shallow=False)
