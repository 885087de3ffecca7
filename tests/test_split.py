"""Split-stage tests: CIGAR intervals, tint construction, end-to-end on a
simulated BAM."""

import os

import pytest

from freddie_jax.config import SplitConfig
from freddie_jax.core.cigar import alignment_intervals
from freddie_jax.io.bam import CDEL, CINS, CMATCH, CREF_SKIP, CSOFT_CLIP
from freddie_jax.io.tsv import parse_split_tsv, load_read_sequences
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate


def test_alignment_intervals_basic():
    # 5S 10M 100N 20M 3S at pos 1000
    cigar = [(CSOFT_CLIP, 5), (CMATCH, 10), (CREF_SKIP, 100), (CMATCH, 20), (CSOFT_CLIP, 3)]
    ivs = alignment_intervals(cigar, 1000, 38)
    assert ivs == [
        (1000, 1010, 5, 15, [(CMATCH, 10)]),
        (1110, 1130, 15, 35, [(CMATCH, 20)]),
    ]


def test_alignment_intervals_long_deletion_becomes_intron():
    cigar = [(CMATCH, 10), (CDEL, 25), (CMATCH, 10)]
    ivs = alignment_intervals(cigar, 0, 20, max_del_size=20)
    assert len(ivs) == 2
    assert ivs[0][:4] == (0, 10, 0, 10)
    assert ivs[1][:4] == (35, 45, 10, 20)
    # a short deletion stays within one interval
    cigar = [(CMATCH, 10), (CDEL, 5), (CMATCH, 10)]
    ivs = alignment_intervals(cigar, 0, 20)
    assert len(ivs) == 1
    assert ivs[0][:4] == (0, 25, 0, 20)


def test_alignment_intervals_insertion():
    cigar = [(CMATCH, 10), (CINS, 4), (CMATCH, 10)]
    ivs = alignment_intervals(cigar, 50, 24)
    assert ivs == [(50, 70, 0, 24, [(CMATCH, 10), (CINS, 4), (CMATCH, 10)])]


@pytest.fixture(scope="module")
def sim_outputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sim")
    sim = simulate(seed=3)
    bam = str(d / "reads.bam")
    fq = str(d / "reads.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    outdir = str(d / "split")
    counts = run_split(bam, [fq], outdir, SplitConfig())
    return sim, outdir, counts


def test_split_end_to_end(sim_outputs):
    sim, outdir, counts = sim_outputs
    assert counts == {sim.contig: 2}  # two genes -> two tints
    cdir = os.path.join(outdir, sim.contig)
    for tint_id in range(counts[sim.contig]):
        tint = parse_split_tsv(os.path.join(cdir, f"split_{sim.contig}_{tint_id}.tsv"))
        load_read_sequences(
            tint, os.path.join(cdir, f"reads_{sim.contig}_{tint_id}.tsv")
        )
        assert tint.read_count == len(tint.reads) > 0
        # every read's intervals fall inside the tint intervals
        for read in tint.reads:
            for ts, te, qs, qe, _ in read.intervals:
                assert any(s <= ts <= te <= e for s, e in tint.intervals)
            assert len(read.seq) > 0
    # all simulated reads assigned to exactly one tint
    total = sum(
        parse_split_tsv(os.path.join(cdir, f"split_{sim.contig}_{t}.tsv")).read_count
        for t in range(counts[sim.contig])
    )
    assert total == len(sim.reads)


def test_split_read_sequences_orientation(sim_outputs):
    sim, outdir, counts = sim_outputs
    cdir = os.path.join(outdir, sim.contig)
    tint = parse_split_tsv(os.path.join(cdir, f"split_{sim.contig}_0.tsv"))
    load_read_sequences(tint, os.path.join(cdir, f"reads_{sim.contig}_0.tsv"))
    by_name = {r.name: r for r in tint.reads}
    for sr in sim.reads:
        if sr.name in by_name:
            # the distributed sequence is the raw FASTQ one (read orientation)
            assert by_name[sr.name].seq == sr.fastq_seq
            assert by_name[sr.name].strand == sr.strand


def test_distribute_handles_lru_cap(sim_outputs, tmp_path):
    # With the open-handle cap forced below the tint count, evicted files
    # reopen in append mode and the outputs stay byte-identical.
    import filecmp
    import shutil

    from freddie_jax.stages.split import distribute_read_sequences

    sim, outdir, counts = sim_outputs
    cdir = os.path.join(outdir, sim.contig)
    # Rebuild rname_to_tint from the split TSVs.
    rname_to_tint = {}
    for t in range(counts[sim.contig]):
        tint = parse_split_tsv(os.path.join(cdir, f"split_{sim.contig}_{t}.tsv"))
        for read in tint.reads:
            entry = rname_to_tint.setdefault(
                read.name, dict(contig=sim.contig, rid=read.id, tint_ids=[])
            )
            entry["tint_ids"].append(t)
    fq = str(tmp_path / "reads.fastq")
    sim.write_fastq(fq)
    capped = str(tmp_path / "capped")
    os.makedirs(os.path.join(capped, sim.contig))
    distribute_read_sequences([fq], rname_to_tint, capped, max_open_handles=1)
    for t in range(counts[sim.contig]):
        a = os.path.join(cdir, f"reads_{sim.contig}_{t}.tsv")
        b = os.path.join(capped, sim.contig, f"reads_{sim.contig}_{t}.tsv")
        assert filecmp.cmp(a, b, shallow=False), f"tint {t} differs under LRU cap"
