"""Oversized-tint breaking (py/freddie_split.py:214-258): a tint above the
read cap splits into junction-graph components, a read whose intervals
touch two components is emitted into BOTH sub-tints, and the split TSVs
match the reference byte-for-byte."""

import glob
import os
import random
import subprocess
import sys

import pytest

from freddie_jax.config import SplitConfig
from freddie_jax.io.bam import CMATCH, CREF_SKIP
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import (
    Simulation,
    SimRead,
    make_gene,
    make_isoforms,
    random_genome,
    simulate_read,
)

REF = "/root/reference/py"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("breaktint")
    rng = random.Random(42)
    genome = random_genome(2_000_000, rng)
    sim = Simulation(contig="chr1", contig_len=2_000_000, genome=genome,
                     transcripts=[])
    # Two genes, >1500 reads total so the merged tint exceeds the cap.
    gA = make_gene(rng, "chr1", 10_000, 4)
    gB = make_gene(rng, "chr1", gA[-1][1] + 5_000, 4)
    for gid, exons in ((0, gA), (1, gB)):
        for tr in make_isoforms(rng, exons, 2, "chr1", gid):
            sim.transcripts.append(tr)
            for i in range(400):
                sim.reads.append(simulate_read(rng, sim, tr, i))
    # ONE chimeric read bridging A's last exon to B's first exon: its
    # junction has weight 1, below the keep threshold, so break_tint drops
    # the edge and yields two components -- but the read's intervals touch
    # both, so it must appear in both sub-tints.
    bs, be = gA[-1]
    cs, ce = gB[0]
    body = genome[bs:be] + genome[cs:ce]
    sim.reads.append(SimRead(
        name="bridge_1", transcript="X", contig="chr1", strand="+",
        exons=[(bs, be), (cs, ce)], fastq_seq=body, aligned_seq=body,
        cigar=[(CMATCH, be - bs), (CREF_SKIP, cs - be), (CMATCH, ce - cs)],
        pos=bs,
    ))
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    our = str(d / "our_split")
    counts = run_split(bam, [fq], our, SplitConfig())
    return d, bam, fq, our, counts


def test_breaks_into_two_subtints_with_shared_read(fixture):
    d, bam, fq, our, counts = fixture
    assert counts == {"chr1": 2}
    tsvs = sorted(glob.glob(os.path.join(our, "chr1", "split_*.tsv")))
    assert len(tsvs) == 2
    hits = [f for f in tsvs if "bridge_1" in open(f).read()]
    assert len(hits) == 2, "bridge read must be a member of both sub-tints"
    # and its sequence is distributed to both per-tint reads files
    # (reads_*.tsv rows are keyed by read index, not name)
    bridge_idx = None
    for f in tsvs:
        for line in open(f):
            cols = line.rstrip("\n").split("\t")
            if len(cols) > 1 and cols[1] == "bridge_1":
                bridge_idx = cols[0]
    assert bridge_idx is not None
    reads = sorted(glob.glob(os.path.join(our, "chr1", "reads_*.tsv")))
    assert len(reads) == 2
    for f in reads:
        assert any(line.split("\t", 1)[0] == bridge_idx for line in open(f)), f


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference not mounted")
def test_matches_reference(fixture):
    d, bam, fq, our, counts = fixture
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}/tests/pysam_shim:{REPO}:" + env.get("PYTHONPATH", "")
    ref = str(d / "ref_split")
    proc = subprocess.run(
        [sys.executable, os.path.join(REF, "freddie_split.py"),
         "-b", bam, "-r", fq, "-o", ref],
        capture_output=True, text=True, env=env, timeout=240,
    )
    assert proc.returncode == 0, proc.stderr[-500:]
    ours = sorted(glob.glob(os.path.join(our, "chr1", "split_*.tsv")))
    refs = sorted(glob.glob(os.path.join(ref, "chr1", "split_*.tsv")))
    assert [os.path.basename(f) for f in ours] == [os.path.basename(f) for f in refs]
    for a, b in zip(ours, refs):
        assert open(a).read() == open(b).read(), os.path.basename(a)
