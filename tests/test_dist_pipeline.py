"""Distributed pipeline (emulated multi-host) equals the single-process
pipeline byte-for-byte."""

import os

from freddie_jax.config import PipelineConfig
from freddie_jax.parallel.dist import run_pipeline_distributed
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.sim import simulate


def test_emulated_two_host_pipeline_matches_single(tmp_path):
    sim = simulate(seed=61, n_genes=4, isoforms_per_gene=2, reads_per_isoform=8,
                   minus_strand_genes=True, alt_splice=True, junction_jitter=3)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)

    single = str(tmp_path / "single")
    run_pipeline(bam, [fq], single, PipelineConfig(), log=lambda *a: None)
    want = open(os.path.join(single, "isoforms.gtf")).read()

    # Emulate 2 hosts sharing a filesystem: each runs its shard; the
    # collective degenerates to local sorts, and the shards' sorted union
    # must equal the single-process GTF.
    shared = str(tmp_path / "shared")
    records = []
    for pi in range(2):
        records.extend(
            run_pipeline_distributed(
                bam, [fq], shared, PipelineConfig(),
                process_index=pi, process_count=2, log=lambda *a: None,
            )
        )
    merged = sorted(set(records))
    text = "".join(t + "\n" for _k, t in merged)
    assert text == want
    # each segment/cluster TSV written by the owning host matches the
    # single-process one byte-for-byte
    for stage in ("segment", "cluster"):
        sdir = os.path.join(shared, stage, "chr1")
        for fn in sorted(os.listdir(sdir)):
            a = open(os.path.join(sdir, fn)).read()
            b = open(os.path.join(single, stage, "chr1", fn)).read()
            assert a == b, (stage, fn)
