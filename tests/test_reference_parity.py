"""Byte-level parity against the ACTUAL reference implementation.

The reference scripts (read-only at /root/reference) are executed in
subprocesses with a pysam shim backed by our BAM codec
(tests/pysam_shim), on the same simulated inputs, and their stage outputs
are compared byte-for-byte with ours:

  - split:   split_*.tsv identical; reads_*.tsv identical as line sets
             (the reference shell-sorts an intermediate; row order within
             a per-tint file is meaningless downstream);
  - segment: segment_*.tsv identical -- this exercises the full float
             parity surface (scipy smoothing, find_peaks, the DP,
             refinement, genotyping, polyA annotation);
  - isoforms: the reference's isoforms stage run on OUR cluster output
             must produce a GTF identical to ours.

The cluster stage has no runnable reference here (Gurobi license); its
parity evidence is the brute-force optimality suite (tests/test_solver.py).
"""

import glob
import os
import subprocess
import sys

import pytest

REF = "/root/reference/py"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIM = os.path.join(REPO, "tests", "pysam_shim")

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF), reason="reference not mounted"
)


def run_reference(script: str, args: list[str]) -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{SHIM}:{REPO}:" + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, os.path.join(REF, script)] + args,
        capture_output=True,
        text=True,
        env=env,
        timeout=300,
    )
    assert proc.returncode == 0, (script, proc.stdout[-2000:], proc.stderr[-2000:])


# FREDDIE_PARITY_SEED shifts every config's seed -- rerunning the suite
# with different values fuzzes fresh inputs against the reference.
_SEED_SHIFT = int(os.environ.get("FREDDIE_PARITY_SEED", "0"))

CONFIGS = {
    "clean": dict(
        seed=2024 + _SEED_SHIFT, n_genes=3, isoforms_per_gene=2, reads_per_isoform=8,
        minus_strand_genes=True, truncate_prob=0.25, tail_prob=0.85,
    ),
    # alt splice sites + junction wobble + >20bp deletions (intron-split
    # noise) make segmentation problems dense (40+ candidates): this runs
    # the DP, refinement and coverage genotyping on non-trivial inputs,
    # and indels exercise CIGAR walking/gap arithmetic
    "noisy": dict(
        seed=4096 + _SEED_SHIFT, n_genes=2, isoforms_per_gene=4, reads_per_isoform=30,
        minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8,
        end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6,
        big_del_rate=0.06,
    ),
    # deep-exon genes, heavier truncation/indels and wider jitter: long
    # candidate runs exercise break_large_problems and the threshold
    # table's short-segment entries (where the nay equality bit lives)
    "gnarly": dict(
        seed=8192 + _SEED_SHIFT, n_genes=2, isoforms_per_gene=5,
        reads_per_isoform=25, exons_per_gene=7, minus_strand_genes=True,
        truncate_prob=0.3, tail_prob=0.7, end_jitter=30, indel_rate=0.15,
        alt_splice=True, junction_jitter=8, big_del_rate=0.1,
    ),
    # --consider-ends flips the splice-signal surface: every read's start
    # and end positions join the signal (py/freddie_segment.py:656-668),
    # changing candidate peaks, the DP inputs and refinement everywhere
    "ends": dict(
        seed=5120 + _SEED_SHIFT, n_genes=2, isoforms_per_gene=3,
        reads_per_isoform=20, minus_strand_genes=True, truncate_prob=0.3,
        tail_prob=0.8, end_jitter=20, indel_rate=0.08, alt_splice=True,
        junction_jitter=5, _consider_ends=True,
    ),
    # --consider-nonspliced admits single-exon reads into tints
    # (py/freddie_split.py:240-247); segmentation then runs on intronless
    # signal where only read ends carve segments
    "nonspliced": dict(
        seed=6144 + _SEED_SHIFT, n_genes=3, isoforms_per_gene=2,
        reads_per_isoform=12, exons_per_gene=1, minus_strand_genes=True,
        truncate_prob=0.2, tail_prob=0.8, end_jitter=15, indel_rate=0.05,
        _consider_nonspliced=True,
    ),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def fixture(request, tmp_path_factory):
    from freddie_jax.utils.sim import simulate

    d = tmp_path_factory.mktemp(f"refparity_{request.param}")
    kwargs = dict(CONFIGS[request.param])
    opts = {
        "consider_ends": kwargs.pop("_consider_ends", False),
        "consider_nonspliced": kwargs.pop("_consider_nonspliced", False),
    }
    sim = simulate(**kwargs)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    return d, bam, fq, opts


@pytest.fixture(scope="module")
def both_splits(fixture):
    d, bam, fq, opts = fixture
    ref_split = str(d / "ref_split")
    ref_args = ["-b", bam, "-r", fq, "-o", ref_split]
    if opts["consider_nonspliced"]:
        ref_args.insert(0, "--consider-nonspliced")
    run_reference("freddie_split.py", ref_args)

    from freddie_jax.config import SplitConfig
    from freddie_jax.stages.split import run_split

    our_split = str(d / "our_split")
    run_split(bam, [fq], our_split,
              SplitConfig(consider_nonspliced=opts["consider_nonspliced"]))
    return d, ref_split, our_split, opts


def _files(root, pattern):
    return sorted(
        os.path.relpath(p, root)
        for p in glob.glob(os.path.join(root, "**", pattern), recursive=True)
    )


def test_split_outputs_identical(both_splits):
    d, ref_split, our_split, _opts = both_splits
    ref_files = _files(ref_split, "split_*.tsv")
    our_files = _files(our_split, "split_*.tsv")
    assert ref_files == our_files and ref_files
    for rel in ref_files:
        a = open(os.path.join(ref_split, rel)).read()
        b = open(os.path.join(our_split, rel)).read()
        assert a == b, f"{rel} differs"
    # read-sequence files: same sets of rows per tint
    ref_reads = [f for f in _files(ref_split, "reads_*.tsv")]
    our_reads = [f for f in _files(our_split, "reads_*.tsv")]
    assert ref_reads == our_reads
    for rel in ref_reads:
        a = sorted(open(os.path.join(ref_split, rel)).read().splitlines())
        b = sorted(open(os.path.join(our_split, rel)).read().splitlines())
        assert a == b, f"{rel} row sets differ"


@pytest.fixture(scope="module")
def both_segments(both_splits):
    d, ref_split, our_split, opts = both_splits
    ref_seg = str(d / "ref_segment")
    os.makedirs(ref_seg, exist_ok=True)
    ref_args = ["-s", ref_split, "-o", ref_seg]
    if opts["consider_ends"]:
        ref_args += ["--consider-ends", "True"]
    run_reference("freddie_segment.py", ref_args)

    from freddie_jax.config import SegmentConfig
    from freddie_jax.stages.segment import run_segment

    our_seg = str(d / "our_segment")
    run_segment(our_split, our_seg,
                SegmentConfig(consider_ends=opts["consider_ends"]))
    return d, ref_split, our_split, ref_seg, our_seg


def test_segment_outputs_identical(both_segments):
    d, ref_split, our_split, ref_seg, our_seg = both_segments
    ref_files = _files(ref_seg, "segment_*.tsv")
    our_files = _files(our_seg, "segment_*.tsv")
    assert ref_files == our_files and ref_files
    for rel in ref_files:
        a = open(os.path.join(ref_seg, rel)).read()
        b = open(os.path.join(our_seg, rel)).read()
        assert a == b, f"{rel} differs"


def test_isoforms_stage_matches_reference(both_segments, tmp_path_factory):
    d, ref_split, our_split, ref_seg, our_seg = both_segments
    from freddie_jax.config import ClusterConfig, IsoformsConfig
    from freddie_jax.stages.cluster import run_cluster
    from freddie_jax.stages.isoforms import run_isoforms

    our_cluster = str(d / "our_cluster")
    run_cluster(our_seg, our_cluster, ClusterConfig())

    ref_gtf = str(d / "ref.gtf")
    run_reference(
        "freddie_isoforms.py",
        ["-s", ref_split, "-c", our_cluster, "-o", ref_gtf],
    )
    our_gtf = str(d / "our.gtf")
    run_isoforms(our_split, our_cluster, our_gtf, IsoformsConfig())
    assert open(ref_gtf).read() == open(our_gtf).read()
