"""native/floatsig.c must be a BIT-exact twin of the scipy float surface
(ops/signal.py): smoothing, peak candidates, and segment refinement.
Fuzzed directly against scipy, plus whole-stage byte-compares."""

import filecmp
import os

import numpy as np
import pytest

from freddie_jax.ops.floatsig import gaussian_kernel, load_floatsig
from freddie_jax.ops import signal as sig

eng = load_floatsig()
pytestmark = pytest.mark.skipif(eng is None, reason="no C toolchain")


def _signals(rng, n):
    """Integer-valued float64 splice-signal-like arrays with plateaus and
    zero runs (the shapes that exercise scipy's plateau handling)."""
    y = rng.integers(0, 30, size=n).astype(np.float64)
    if rng.random() < 0.3:
        y[rng.random(n) < 0.5] = 0.0
    if rng.random() < 0.3:
        k = int(rng.integers(1, 5))
        y = np.repeat(y, k)[:n]
    return y


def test_surface_bitexact_fuzz():
    rng = np.random.default_rng(11)
    for trial in range(400):
        n_iv = int(rng.integers(1, 5))
        ys = [_signals(rng, int(rng.integers(1, 250))) for _ in range(n_iv)]
        sigma = float(rng.choice([1.0, 2.5, 5.0, 7.0, 0.6]))
        sm_b, cands = eng.surface(ys, gaussian_kernel(sigma, 4.0))
        for y, b, cl in zip(ys, sm_b, cands):
            want_sm = sig.smooth_signal(y, sigma)
            assert b == want_sm.tobytes(), (trial, sigma, len(y))
            assert cl == sig.candidates_from_peaks(want_sm), (trial, sigma)


def _sparse_signals(rng, n):
    """Sparse integer signals: isolated identical spikes smooth to exactly
    tied peak priorities, exercising the defer-to-numpy-argsort path."""
    y = np.zeros(n)
    k = int(rng.integers(1, max(2, n // 10)))
    pos = rng.integers(0, n, size=k)
    y[pos] = rng.integers(1, 4, size=k).astype(np.float64)
    return y


def test_refine_bitexact_fuzz():
    rng = np.random.default_rng(12)
    n_nontrivial = 0
    n_ties = 0
    for trial in range(600):
        n = int(rng.integers(10, 600))
        y = _sparse_signals(rng, n) if trial % 2 else _signals(rng, n)
        sigma = float(rng.choice([1.0, 2.5, 5.0]))
        # random ascending final breakpoints incl. both ends
        k = int(rng.integers(0, 6))
        inner = sorted(set(rng.integers(1, max(2, n), size=k).tolist()))
        final_ys = [0] + [v for v in inner if v < n] + [n]
        want = sorted(sig.refine_segmentation_scipy(y, final_ys, sigma))
        _, ties = eng.refine(
            np.ascontiguousarray(y), final_ys, gaussian_kernel(sigma, 1.0),
            sigma, 20, 20.0,
        )
        n_ties += len(ties)
        # the dispatcher merges the native result with the numpy-argsort
        # completion of deferred tie segments; only the multiset matters
        # (the consumer sorts), so compare sorted
        got = sorted(sig.refine_segmentation(y, final_ys, sigma))
        assert got == want, (trial, sigma, n, final_ys)
        n_nontrivial += bool(want)
    assert n_nontrivial > 10  # the fuzz actually exercised refinement
    assert n_ties > 10  # ... including the tie-deferral path


def test_refine_tie_deferred():
    """Two identical, well-separated peaks -> exactly tied priorities ->
    the native refine defers that segment, and the dispatcher completes
    it to the exact scipy result."""
    n = 200
    y = np.zeros(n)
    y[60] = 50.0
    y[140] = 50.0
    final_ys = [0, n]
    sigma = 5.0
    done, ties = eng.refine(
        np.ascontiguousarray(y), final_ys, gaussian_kernel(sigma, 1.0),
        sigma, 20, 20.0,
    )
    assert done == [] and len(ties) == 1
    s, g_b, peaks = ties[0]
    assert s == 0 and len(peaks) == 2
    want = sig.refine_segmentation_scipy(y, final_ys, sigma)
    assert sorted(sig.refine_segmentation(y, final_ys, sigma)) == sorted(want)
    assert want  # both peaks survive (distance 80 > skip)


def test_variance_threshold_matches_list_comprehension():
    """The vectorized masked-concatenate must equal the reference's
    per-element list comprehension bit for bit (same values, same order,
    same numpy reductions)."""
    rng = np.random.default_rng(13)
    for _ in range(100):
        smoothed = [
            sig.smooth_signal(_signals(rng, int(rng.integers(1, 200))), 5.0)
            for _ in range(int(rng.integers(1, 4)))
        ]
        vals = np.array([v for y in smoothed for v in y if v > 0])
        import warnings

        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            want = vals.mean() + 3.0 * vals.std()
        got = sig.variance_threshold(smoothed, 3.0)
        assert (np.isnan(want) and np.isnan(got)) or got == want


def test_segment_stage_byte_identical(tmp_path, monkeypatch):
    """Whole segment stage with the native float surface vs FREDDIE_FLOATSIG=0
    (pure scipy) -> byte-identical TSVs."""
    from freddie_jax.config import SegmentConfig, SplitConfig
    from freddie_jax.stages import segment as seg
    from freddie_jax.stages.split import run_split
    from freddie_jax.utils.sim import simulate

    sim = simulate(
        seed=79, n_genes=6, isoforms_per_gene=3, reads_per_isoform=12,
        end_jitter=25, indel_rate=0.1, junction_jitter=6, alt_splice=True,
        big_del_rate=0.06,
    )
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split_dir = str(tmp_path / "split")
    run_split(bam, [fq], split_dir, SplitConfig())

    monkeypatch.setenv("FREDDIE_FLOATSIG", "0")
    ref_out = str(tmp_path / "scipy")
    seg.run_segment(split_dir, ref_out, SegmentConfig())
    monkeypatch.delenv("FREDDIE_FLOATSIG")
    got_out = str(tmp_path / "native")
    seg.run_segment(split_dir, got_out, SegmentConfig())

    ref_files, got_files = [], []
    for base, acc in ((ref_out, ref_files), (got_out, got_files)):
        for root, _dirs, fns in os.walk(base):
            for fn in sorted(fns):
                acc.append(os.path.join(root, fn))
        acc.sort()
    assert [os.path.relpath(f, ref_out) for f in ref_files] == [
        os.path.relpath(f, got_out) for f in got_files
    ]
    assert ref_files
    for a, b in zip(ref_files, got_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, ref_out)
