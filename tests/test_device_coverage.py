"""Device-side coverage builder: C built on device from interval lists
must match the host cumulative_coverage in every difference the kernels
consume, and the whole segment stage must be byte-identical with the
path on or off."""

import filecmp
import os

import numpy as np
import pytest

from freddie_jax.config import SegmentConfig, SplitConfig
from freddie_jax.ops.coverage import build_coverage_device, cumulative_coverage
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate


def test_builder_matches_host_differences():
    """Random interval sets: device-built C equals host C up to a
    per-(problem, rep) additive constant (exactly what cancels in the
    kernels), and equals it exactly when every interval is shipped."""
    rng = np.random.default_rng(3)
    B, I, P, R = 5, 37, 9, 12
    iv = np.zeros((B, I, 3), dtype=np.int32)
    y = np.sort(rng.integers(1, 5000, size=(B, P)).astype(np.int32), axis=1)
    host_Cs = []
    for b in range(B):
        s = rng.integers(0, 4800, size=I)
        e = s + rng.integers(0, 300, size=I)
        r = rng.integers(0, R, size=I)
        iv[b, :, 0] = s
        iv[b, :, 1] = e
        iv[b, :, 2] = r
        # host C at the same candidates (rows 0..P-1 of the (P+1, R)
        # matrix correspond to "before cands[c]")
        C = cumulative_coverage(s.astype(np.int64), e.astype(np.int64),
                                r.astype(np.int64), R, y[b].astype(np.int64),
                                validate=True)
        host_Cs.append(np.asarray(C[:P], dtype=np.int64))
    got = np.asarray(build_coverage_device(iv, y, R)).astype(np.int64)
    for b in range(B):
        want = host_Cs[b]
        # all intervals shipped -> exactly equal (no below-range offset)
        assert np.array_equal(got[b], want), b
        # difference form (what the kernels consume)
        dg = got[b][None, :, :] - got[b][:, None, :]
        dw = want[None, :, :] - want[:, None, :]
        assert np.array_equal(dg, dw)


def test_builder_offset_invariance():
    """Dropping intervals entirely below the candidate range shifts C by
    a per-rep constant only -- differences unchanged."""
    rng = np.random.default_rng(4)
    I, P, R = 20, 6, 5
    s = rng.integers(0, 1000, size=I)
    e = s + rng.integers(0, 100, size=I)
    r = rng.integers(0, R, size=I)
    y = np.sort(rng.integers(1500, 4000, size=P).astype(np.int32))
    below = e < int(y[0])
    full = np.stack([s, e, r], axis=1).astype(np.int32)[None]
    subset = full[:, ~below, :]
    C_full = np.asarray(build_coverage_device(full, y[None], R)).astype(np.int64)
    C_sub = np.asarray(build_coverage_device(subset, y[None], R)).astype(np.int64)
    diff = C_full[0] - C_sub[0]
    # constant per rep across candidate rows
    assert np.all(diff == diff[0:1, :])
    assert below.any(), "fixture should actually drop something"


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("devcov")
    sim = simulate(seed=47, n_genes=3, isoforms_per_gene=3,
                   reads_per_isoform=20, alt_splice=True, junction_jitter=5,
                   indel_rate=0.08, big_del_rate=0.05, truncate_prob=0.2,
                   tail_prob=0.8)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(d / "split")
    run_split(bam, [fq], out, SplitConfig())
    return out


def _tsv_set(outdir):
    return sorted(
        os.path.join(r, f)
        for r, _dirs, fns in os.walk(outdir)
        for f in fns
    )


def test_stage_byte_identical(split_dir, tmp_path, monkeypatch):
    """Whole stage with the device-coverage path FORCED on (device
    dispatch gate at 0) vs forced off: byte-identical TSVs, and the
    builder must actually run."""
    from freddie_jax.ops import coverage as cov
    from freddie_jax.stages import segment as seg

    monkeypatch.setattr(seg, "DEVICE_MIN_WORK", 0)
    monkeypatch.setattr(seg, "DEVICE_COVERAGE_MIN_TINTS", 0)
    calls = {"n": 0}
    orig = cov.build_coverage_device

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(cov, "build_coverage_device", counted)
    on_out = str(tmp_path / "on")
    off_out = str(tmp_path / "off")
    monkeypatch.setenv("FREDDIE_DEVICE_COVERAGE", "0")
    seg.run_segment(split_dir, off_out, SegmentConfig())
    assert calls["n"] == 0
    monkeypatch.delenv("FREDDIE_DEVICE_COVERAGE")
    seg.run_segment(split_dir, on_out, SegmentConfig())
    assert calls["n"] > 0, "device-coverage path never engaged"
    off_files = _tsv_set(off_out)
    on_files = _tsv_set(on_out)
    assert [os.path.relpath(f, off_out) for f in off_files] == [
        os.path.relpath(f, on_out) for f in on_files
    ]
    assert off_files
    for a, b in zip(off_files, on_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, off_out)
