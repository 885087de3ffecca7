"""The segment driver's windowed-streaming knob (SegmentConfig.stream_window).

At 100M scale the in-order drain means one problem parked in a rare
(P, R) bucket keeps every later tint's capsule resident; the window
force-flushes partial buckets every N tints. Outputs must be
byte-identical: chunk composition never affects per-problem DP
solutions (each problem is solved independently; padding rows replicate
problem 0 and their outputs are discarded)."""

import os

from freddie_jax.config import SegmentConfig, SplitConfig
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate

import pytest


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    work = tmp_path_factory.mktemp("streamwin")
    sim = simulate(seed=58, n_genes=4, isoforms_per_gene=3,
                   reads_per_isoform=25, truncate_prob=0.2, end_jitter=15,
                   junction_jitter=4, indel_rate=0.08, alt_splice=True)
    bam = str(work / "sim.bam")
    fq = str(work / "sim.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(work / "split")
    run_split(bam, [fq], out, SplitConfig())
    return out


def _tsv_bytes(outdir):
    files = sorted(
        os.path.join(dp, f)
        for dp, _dn, fns in os.walk(outdir)
        for f in fns
        if f.endswith(".tsv")
    )
    assert files
    return {
        os.path.relpath(f, outdir): open(f, "rb").read() for f in files
    }


def test_windowed_streaming_byte_identical(split_dir, tmp_path, monkeypatch):
    from freddie_jax.stages import segment as seg

    monkeypatch.setattr(seg, "DEVICE_MIN_WORK", 0)  # engage device path
    calls = {"n": 0}
    orig = seg.dispatch_batch_device

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(seg, "dispatch_batch_device", counted)

    plain_out = str(tmp_path / "plain")
    seg.run_segment(split_dir, plain_out, SegmentConfig())
    plain_calls = calls["n"]
    assert plain_calls > 0

    calls["n"] = 0
    win_out = str(tmp_path / "win")
    seg.run_segment(split_dir, win_out, SegmentConfig(stream_window=1))
    # window=1 flushes after every tint: strictly more, smaller launches.
    assert calls["n"] > plain_calls

    assert _tsv_bytes(plain_out) == _tsv_bytes(win_out)


def test_window_env_override(split_dir, tmp_path, monkeypatch):
    from freddie_jax.stages import segment as seg

    monkeypatch.setattr(seg, "DEVICE_MIN_WORK", 0)
    calls = {"n": 0}
    orig = seg.dispatch_batch_device

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(seg, "dispatch_batch_device", counted)

    base_out = str(tmp_path / "base")
    seg.run_segment(split_dir, base_out, SegmentConfig())
    base_calls = calls["n"]

    calls["n"] = 0
    monkeypatch.setenv("FREDDIE_SEGMENT_WINDOW", "1")
    env_out = str(tmp_path / "env")
    seg.run_segment(split_dir, env_out, SegmentConfig())
    assert calls["n"] > base_calls
    assert _tsv_bytes(base_out) == _tsv_bytes(env_out)


def test_auto_window_engages_on_huge_corpora(split_dir, tmp_path, monkeypatch):
    """Corpora with >= AUTO_WINDOW_MIN_TINTS tints get a default window
    even at stream_window=0 (memory bounded by default at 10M+ scale)."""
    from freddie_jax.stages import segment as seg

    monkeypatch.setattr(seg, "DEVICE_MIN_WORK", 0)
    monkeypatch.setattr(seg, "AUTO_WINDOW_MIN_TINTS", 1)
    monkeypatch.setattr(seg, "AUTO_WINDOW", 1)
    calls = {"n": 0}
    orig = seg.dispatch_batch_device

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(seg, "dispatch_batch_device", counted)
    auto_out = str(tmp_path / "auto")
    seg.run_segment(split_dir, auto_out, SegmentConfig())
    auto_calls = calls["n"]

    calls["n"] = 0
    monkeypatch.setattr(seg, "AUTO_WINDOW_MIN_TINTS", 10**9)  # off
    plain_out = str(tmp_path / "plain")
    seg.run_segment(split_dir, plain_out, SegmentConfig())
    assert auto_calls > calls["n"]
    assert _tsv_bytes(plain_out) == _tsv_bytes(auto_out)
