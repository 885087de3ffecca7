"""Native isoforms engine (native/isocore.cpp): whole-stage GTF output
must be byte-identical to the Python oracle path across sim configs and
non-default correction knobs."""

import os

import pytest

from freddie_jax.config import (
    ClusterConfig, IsoformsConfig, SegmentConfig, SplitConfig,
)
from freddie_jax.ops.isocore import load_isocore
from freddie_jax.stages.cluster import run_cluster
from freddie_jax.stages.isoforms import run_isoforms
from freddie_jax.stages.segment import run_segment
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate

eng = load_isocore()
pytestmark = pytest.mark.skipif(eng is None, reason="isocore did not build")

CONFIGS = {
    31: dict(seed=31),
    88: dict(
        seed=88, n_genes=3, isoforms_per_gene=4, reads_per_isoform=25,
        minus_strand_genes=True, truncate_prob=0.25, tail_prob=0.8,
        end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6,
        big_del_rate=0.06,
    ),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def staged(tmp_path_factory, request):
    d = tmp_path_factory.mktemp(f"isocore{request.param}")
    sim = simulate(**CONFIGS[request.param])
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split = str(d / "split")
    run_split(bam, [fq], split, SplitConfig())
    seg = str(d / "segment")
    run_segment(split, seg, SegmentConfig())
    clu = str(d / "cluster")
    run_cluster(seg, clu, ClusterConfig())
    return split, clu


@pytest.mark.parametrize(
    "cfg",
    [
        IsoformsConfig(),
        IsoformsConfig(majority_threshold=0.75, correction_window=3),
        IsoformsConfig(correction_window=0),
    ],
    ids=["default", "maj75-w3", "w0"],
)
def test_gtf_byte_identical(staged, tmp_path, monkeypatch, cfg):
    split, clu = staged
    py_gtf = str(tmp_path / "py.gtf")
    nat_gtf = str(tmp_path / "nat.gtf")
    monkeypatch.setenv("FREDDIE_ISOCORE", "0")
    n_py = run_isoforms(split, clu, py_gtf, cfg)
    monkeypatch.delenv("FREDDIE_ISOCORE")
    n_nat = run_isoforms(split, clu, nat_gtf, cfg)
    assert n_py == n_nat > 0
    assert open(py_gtf).read() == open(nat_gtf).read()


def test_error_falls_back(staged, tmp_path, monkeypatch):
    """A native-side failure degrades to the Python path per tint."""
    import freddie_jax.ops.isocore as ic

    split, clu = staged
    monkeypatch.setenv("FREDDIE_ISOCORE", "0")
    py_gtf = str(tmp_path / "py.gtf")
    run_isoforms(split, clu, py_gtf, IsoformsConfig())
    monkeypatch.delenv("FREDDIE_ISOCORE")

    def explode(*a, **k):
        raise AssertionError("forced isocore failure")

    monkeypatch.setattr(ic, "tint_gtf_native", explode)
    # stages.isoforms imports the symbol per call, so the patch must be
    # applied to the module attr it resolves.
    import freddie_jax.stages.isoforms  # noqa: F401

    nat_gtf = str(tmp_path / "nat.gtf")
    run_isoforms(split, clu, nat_gtf, IsoformsConfig())
    assert open(py_gtf).read() == open(nat_gtf).read()
