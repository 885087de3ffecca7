"""Production device paths of the segment stage: the batched polyA
annotator and the multi-device sharded DP dispatch must both be used in
production and byte-match the host path."""

import filecmp
import os

import pytest

from freddie_jax.config import SegmentConfig, SplitConfig
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("segdev")
    sim = simulate(seed=31)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(d / "split")
    run_split(bam, [fq], out, SplitConfig())
    return out


def _tsv_set(outdir):
    files = []
    for root, _dirs, fns in os.walk(outdir):
        for fn in sorted(fns):
            files.append(os.path.join(root, fn))
    return sorted(files)


def test_segment_polya_device_byte_identical(split_dir, tmp_path, monkeypatch):
    """Forcing the batched device polyA path produces TSVs byte-identical
    to the host annotator."""
    from freddie_jax.stages import segment as seg

    host_out = str(tmp_path / "host")
    dev_out = str(tmp_path / "dev")
    monkeypatch.setattr(seg, "POLYA_DEVICE_MIN_READS", 10**9)
    seg.run_segment(split_dir, host_out, SegmentConfig())
    monkeypatch.setattr(seg, "POLYA_DEVICE_MIN_READS", 0)
    # The stage only batches when a device route will engage; force it on
    # the CPU test backend (the same env the production override uses).
    monkeypatch.setenv("FREDDIE_POLYA_DEVICE", "1")
    seg.run_segment(split_dir, dev_out, SegmentConfig())
    host_files = _tsv_set(host_out)
    dev_files = _tsv_set(dev_out)
    assert [os.path.relpath(f, host_out) for f in host_files] == [
        os.path.relpath(f, dev_out) for f in dev_files
    ]
    assert host_files
    for a, b in zip(host_files, dev_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, host_out)


def test_solve_batch_device_uses_sharded_dispatch():
    """With >1 local device (conftest forces 8 virtual CPU devices),
    solve_batch_device routes through the loci-mesh sharded solver --
    including batch sizes that need mesh-multiple padding -- and matches
    the host oracle bit for bit."""
    import jax
    import numpy as np

    from freddie_jax.ops.segdp import DPProblem, solve_batch_device, solve_host
    from freddie_jax.ops.thresholds import ScaledThresholds
    from freddie_jax.parallel import mesh as mesh_mod

    assert jax.local_device_count() > 1
    rng = np.random.default_rng(7)
    thr = ScaledThresholds(0.9)
    problems = []
    for _ in range(13):  # 13 % 8 != 0 -> exercises the pad-and-trim path
        P = int(rng.integers(5, 14))
        R = int(rng.integers(3, 30))
        y = np.sort(rng.choice(np.arange(1000), size=P, replace=False)).astype(np.int64)
        lens = np.diff(np.concatenate([[0], y]))
        C = np.cumsum(
            rng.integers(0, lens[:, None] + 1, size=(P, R)), axis=0
        ).astype(np.int64)
        problems.append(
            DPProblem(
                C=C,
                y=y,
                W=rng.integers(1, 5, size=R).astype(np.int64),
                read_support=3,
            )
        )
    mesh_mod._fn_cache.clear()
    got = solve_batch_device(problems, thr)
    assert mesh_mod._fn_cache, "sharded dispatch was not used"
    want = [solve_host(p, thr) for p in problems]
    assert got == want


def test_streaming_chunks_and_flush_padding(tmp_path, monkeypatch):
    """Tiny streaming chunks force mid-phase-A dispatches, multi-chunk
    tints, and the flush path that pads a final partial chunk up to the
    bucket's standard shape -- outputs must stay byte-identical to the
    all-at-once host solve. (A noisy simulation: the clean fixture's
    problems are all trivial and would never dispatch.)"""
    from freddie_jax.ops import segdp
    from freddie_jax.stages import segment as seg

    sim = simulate(
        seed=77, n_genes=8, isoforms_per_gene=3, reads_per_isoform=12,
        end_jitter=25, indel_rate=0.1, junction_jitter=6, alt_splice=True,
        big_del_rate=0.06,
    )
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split_dir = str(tmp_path / "split")
    run_split(bam, [fq], split_dir, SplitConfig())

    ref_out = str(tmp_path / "ref")
    cfg_host = SegmentConfig(use_device=False)
    seg.run_segment(split_dir, ref_out, cfg_host)

    dispatched = []
    orig = segdp.dispatch_batch_device

    def spy(problems, thr, pad_p_to=8, pad_r_to=128, pad_b_to=0, **kw):
        dispatched.append((len(problems), pad_b_to))
        return orig(problems, thr, pad_p_to, pad_r_to, pad_b_to, **kw)

    monkeypatch.setattr(seg, "STREAM_CHUNK_MAX", 8)
    monkeypatch.setattr(seg, "DEVICE_MIN_WORK", 0)
    monkeypatch.setattr(seg, "dispatch_batch_device", spy)
    stream_out = str(tmp_path / "stream")
    seg.run_segment(split_dir, stream_out, SegmentConfig())

    assert len(dispatched) > 1, "chunking did not split the workload"
    # At least one full chunk and (if any partial flush followed a full
    # chunk in the same bucket) a pad_b_to equal to the chunk size.
    assert any(n == 8 for n, _pad in dispatched)
    for n, pad in dispatched:
        if pad:
            assert n < 8 and pad == 8

    ref_files = _tsv_set(ref_out)
    got_files = _tsv_set(stream_out)
    assert [os.path.relpath(f, ref_out) for f in ref_files] == [
        os.path.relpath(f, stream_out) for f in got_files
    ]
    for a, b in zip(ref_files, got_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, ref_out)


def test_scale_overflow_host_fallback_collected(tmp_path, monkeypatch):
    """dispatch_batch_device returns (None, [], results) when thr.scale *
    max_operand would overflow int32 and it solved the chunk on the host
    inline. The streaming driver's final collection loop must still
    collect those entries (they are NOT the 'already read back inline'
    sentinel) -- regression test for an assert-death where handles=None
    was overloaded for both meanings."""
    from freddie_jax.ops.segdp import solve_host
    from freddie_jax.stages import segment as seg

    sim = simulate(
        seed=78, n_genes=6, isoforms_per_gene=3, reads_per_isoform=12,
        end_jitter=25, indel_rate=0.1, junction_jitter=6, alt_splice=True,
        big_del_rate=0.06,
    )
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split_dir = str(tmp_path / "split")
    run_split(bam, [fq], split_dir, SplitConfig())

    ref_out = str(tmp_path / "ref")
    seg.run_segment(split_dir, ref_out, SegmentConfig(use_device=False))

    calls = []

    def overflow_fallback(problems, thr, *a, **kw):
        # Mimic segdp.dispatch_batch_device's int32 scale-overflow branch
        # exactly: everything solved on the host, handles=None.
        calls.append(len(problems))
        return None, [], [solve_host(p, thr) for p in problems]

    monkeypatch.setattr(seg, "DEVICE_MIN_WORK", 0)
    monkeypatch.setattr(seg, "dispatch_batch_device", overflow_fallback)
    got_out = str(tmp_path / "got")
    seg.run_segment(split_dir, got_out, SegmentConfig())

    assert calls, "device dispatch (and thus the fallback) never engaged"
    ref_files = _tsv_set(ref_out)
    got_files = _tsv_set(got_out)
    assert [os.path.relpath(f, ref_out) for f in ref_files] == [
        os.path.relpath(f, got_out) for f in got_files
    ]
    assert ref_files
    for a, b in zip(ref_files, got_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, ref_out)


def test_inflight_cap_byte_identical(split_dir, tmp_path, monkeypatch):
    """MAX_INFLIGHT_CHUNKS=1 (every chunk read back inline before the
    next dispatch) produces TSVs byte-identical to the default deep
    pipeline -- the cap only bounds device-resident memory."""
    from freddie_jax.stages import segment as seg

    deep = str(tmp_path / "deep")
    seg.run_segment(split_dir, deep, SegmentConfig())
    monkeypatch.setattr(seg, "MAX_INFLIGHT_CHUNKS", 1)
    capped = str(tmp_path / "capped")
    seg.run_segment(split_dir, capped, SegmentConfig())
    deep_files = _tsv_set(deep)
    capped_files = _tsv_set(capped)
    assert [os.path.relpath(f, deep) for f in deep_files] == [
        os.path.relpath(f, capped) for f in capped_files
    ]
    assert deep_files
    for a, b in zip(deep_files, capped_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, deep)
