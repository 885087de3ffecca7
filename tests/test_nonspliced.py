"""--consider-nonspliced: single-exon reads form tints and isoforms, and
the split output matches the reference run with the same flag."""

import glob
import os
import subprocess
import sys

import pytest

from freddie_jax.config import PipelineConfig, SplitConfig
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate

REF = "/root/reference/py"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    d = tmp_path_factory.mktemp("nonspliced")
    sim = simulate(seed=77, n_genes=2, isoforms_per_gene=1, reads_per_isoform=8,
                   exons_per_gene=1)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    return d, bam, fq


def test_pipeline_recovers_single_exon_genes(fixture):
    d, bam, fq = fixture
    cfg = PipelineConfig(split=SplitConfig(consider_nonspliced=True))
    out = str(d / "out")
    run_pipeline(bam, [fq], out, cfg, log=lambda *a: None)
    gtf = open(os.path.join(out, "isoforms.gtf")).read().splitlines()
    assert sum(1 for l in gtf if l.split("\t")[2] == "transcript") == 2
    assert sum(1 for l in gtf if l.split("\t")[2] == "exon") == 2


@pytest.mark.skipif(not os.path.isdir(REF), reason="reference not mounted")
def test_split_matches_reference_with_flag(fixture):
    d, bam, fq = fixture
    ours = str(d / "our_split")
    run_split(bam, [fq], ours, SplitConfig(consider_nonspliced=True))
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}/tests/pysam_shim:{REPO}:" + env.get("PYTHONPATH", "")
    ref = str(d / "ref_split")
    proc = subprocess.run(
        [sys.executable, os.path.join(REF, "freddie_split.py"),
         "-b", bam, "-r", fq, "--consider-nonspliced", "-o", ref],
        capture_output=True, text=True, env=env, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-500:]
    files = sorted(glob.glob(os.path.join(ours, "**", "split_*.tsv"), recursive=True))
    assert files
    for f in files:
        rel = os.path.relpath(f, ours)
        assert open(f).read() == open(os.path.join(ref, rel)).read(), rel
