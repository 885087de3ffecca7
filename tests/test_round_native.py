"""Consolidated native round solver (native/round_solver.cpp) vs the
rung-by-rung Python chain: bit-identical results on every escalation
outcome the consolidated call covers (phase-1 OPTIMAL, BUDGET -> closure
OPTIMAL, BUDGET -> closure declined -> later rungs)."""

import numpy as np
import pytest

import freddie_jax.solver.native as native_mod
import freddie_jax.solver.segenum as segenum_mod
import freddie_jax.solver.two_phase as tp
from freddie_jax.solver.native import native_available, solve_round_native
from tests.test_solver import random_instance

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no C++ toolchain available"
)


def attach_flat(inst):
    """Fill the flat-array form the way stages/cluster.build_instance
    does (the test generator's gap masks are contiguous ranges)."""
    rows = inst.rows
    N = len(rows)
    Mi = len(inst.seg_len)
    inst.exons_mat = np.stack([r.exons for r in rows]) if N else np.zeros((0, Mi), bool)
    inst.corr_mat = np.stack([r.corr for r in rows]) if N else np.zeros((0, Mi), bool)
    inst.garbage_arr = np.array([r.garbage for r in rows], dtype=np.float64)
    counts, los, his, lens = [], [], [], []
    for r in rows:
        counts.append(len(r.gaps))
        for mask, l in r.gaps:
            nz = np.flatnonzero(mask)
            lo, hi = (int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 0)
            assert np.array_equal(
                np.flatnonzero(mask), np.arange(lo, hi)
            ), "generator gap masks must be contiguous ranges"
            los.append(lo)
            his.append(hi)
            lens.append(int(l))
    inst.gap_counts = np.array(counts, dtype=np.int32)
    inst.gap_lo = np.array(los, dtype=np.int32)
    inst.gap_hi = np.array(his, dtype=np.int32)
    inst.gap_len_arr = np.array(lens, dtype=np.int64)
    return inst


def solve_python_chain(inst, deadline_s=60.0, monkeypatch=None):
    """solve_two_phase with the consolidated native entry disabled, so the
    original rung-by-rung chain runs (phase-1 via the C++/Python twins,
    closure via solve_segment_enum_closure, etc.)."""
    import unittest.mock as mock

    with mock.patch.object(native_mod, "solve_round_native", lambda *a, **k: None):
        return tp.solve_two_phase(inst, deadline_s)


def assert_same(a, b):
    assert a.status == b.status
    assert a.objective == b.objective
    assert a.assigned == b.assigned
    if a.isoform is None or b.isoform is None:
        assert (a.isoform is None) == (b.isoform is None)
    else:
        assert np.array_equal(np.asarray(a.isoform), np.asarray(b.isoform))


@pytest.mark.parametrize("seed", range(15))
def test_closure_cache_multiround_bitexact(seed):
    """The per-partition closure cache (closure_cache_new +
    solve_round_cached) must give BIT-identical outputs to the uncached
    solve_round across simulated partition rounds: reads only removed,
    columns only dropped -- including non-identity projections (column
    drops kill the incremental-bounds cache) and repeated escalations
    (tiny node budget)."""
    import ctypes

    lib = native_mod._load()
    rng = np.random.default_rng(seed + 7700)
    N0 = int(rng.integers(8, 40))
    M0 = int(rng.integers(3, 14))
    I0 = (rng.random((N0, M0)) < 0.45).astype(np.uint8)
    C0 = (I0 | (rng.random((N0, M0)) < 0.2)).astype(np.uint8)
    garbage0 = (rng.integers(1, 12, size=N0) * 0.5).astype(np.float64)
    seg_len0 = rng.integers(1, 50, size=M0).astype(np.int64)
    read_ids0 = np.arange(N0, dtype=np.int32) * 3 + 1  # stable, arbitrary
    col_ids0 = np.arange(M0, dtype=np.int32) * 7 + 2

    cache = lib.closure_cache_new()
    try:
        alive = list(range(N0))
        cols = list(range(M0))
        for rnd in range(6):
            n, m = len(alive), len(cols)
            if n == 0 or m == 0:
                break
            I = np.ascontiguousarray(I0[np.ix_(alive, cols)])
            C = np.ascontiguousarray(C0[np.ix_(alive, cols)])
            garbage = np.ascontiguousarray(garbage0[alive])
            seg_len = np.ascontiguousarray(seg_len0[cols])
            rids = np.ascontiguousarray(read_ids0[alive])
            cids = np.ascontiguousarray(col_ids0[cols])
            gap_counts = np.zeros(n, dtype=np.int32)
            gap_z = np.zeros(1, dtype=np.int32)
            gap_zl = np.zeros(1, dtype=np.int64)

            def run(cached):
                out_assigned = np.zeros(max(n, 1), dtype=np.int32)
                out_n = ctypes.c_int32(0)
                out_obj = ctypes.c_double(0.0)
                words = max((m + 63) // 64, 1)
                out_E = np.zeros(words, dtype=np.uint64)
                out_nodes = ctypes.c_int64(0)

                def p(a, t):
                    return a.ctypes.data_as(ctypes.POINTER(t))

                common = [
                    ctypes.c_int(n), ctypes.c_int(m),
                    p(I, ctypes.c_uint8), p(C, ctypes.c_uint8),
                    p(garbage, ctypes.c_double), p(seg_len, ctypes.c_int64),
                    p(gap_counts, ctypes.c_int32), p(gap_z, ctypes.c_int32),
                    p(gap_z, ctypes.c_int32), p(gap_zl, ctypes.c_int64),
                    ctypes.c_int(0), p(gap_z, ctypes.c_int32),
                    ctypes.c_int64(1000), ctypes.c_int64(100),
                    ctypes.c_int64(0), ctypes.c_double(60.0),
                    ctypes.c_int64(3),  # tiny budget: force escalations
                    ctypes.c_int64(128), ctypes.c_int64(100000),
                    ctypes.c_int64(0),
                ]
                outs = [
                    p(out_assigned, ctypes.c_int32), ctypes.byref(out_n),
                    ctypes.byref(out_obj), p(out_E, ctypes.c_uint64),
                    ctypes.byref(out_nodes),
                ]
                if cached:
                    st = lib.solve_round_cached(
                        *common, ctypes.c_void_p(cache),
                        p(rids, ctypes.c_int32), p(cids, ctypes.c_int32),
                        *outs,
                    )
                else:
                    st = lib.solve_round(*common, *outs)
                return (st, out_n.value,
                        out_assigned[: out_n.value].tolist(),
                        out_obj.value, out_E.tolist(), out_nodes.value)

            want = run(cached=False)
            got = run(cached=True)
            assert got == want, (seed, rnd, n, m)

            # shrink: remove some reads; sometimes drop a column
            if n > 2:
                k = int(rng.integers(1, max(2, n // 3)))
                drop = set(rng.choice(len(alive), size=k, replace=False).tolist())
                alive = [a for i, a in enumerate(alive) if i not in drop]
            if m > 2 and rng.random() < 0.4:
                cols = [c for i, c in enumerate(cols)
                        if i != int(rng.integers(0, m))]
    finally:
        lib.closure_cache_free(ctypes.c_void_p(cache))


@pytest.mark.parametrize("seed", range(20))
def test_round_native_matches_chain(seed):
    rng = np.random.default_rng(seed + 5100)
    N = int(rng.integers(2, 40))
    M = int(rng.integers(1, 14))
    inst = attach_flat(random_instance(rng, N, M))
    got = tp.solve_two_phase(inst, 60.0)
    want = solve_python_chain(inst, 60.0)
    assert got.status == "OPTIMAL"
    assert_same(got, want)


@pytest.mark.parametrize("seed", range(12))
def test_round_native_matches_chain_under_budget(seed, monkeypatch):
    # Tiny node budget forces the BUDGET -> closure escalation in both
    # engines; results (and the phase-1 incumbent filter effects) must
    # stay bit-equal.
    monkeypatch.setattr(tp, "NODE_BUDGET", 5)
    rng = np.random.default_rng(seed + 5200)
    N = int(rng.integers(6, 40))
    M = int(rng.integers(2, 14))
    inst = attach_flat(random_instance(rng, N, M))
    got = tp.solve_two_phase(inst, 60.0)
    want = solve_python_chain(inst, 60.0)
    assert_same(got, want)
    # nodes field may differ between engines only in the closure case
    # (Python reports the closure's 0); statuses must agree.
    assert got.status == "OPTIMAL"


@pytest.mark.parametrize("seed", range(8))
def test_round_native_closure_declined(seed, monkeypatch):
    # Closure cap of 1 forces the decline -> 1b/1c/LP/full continuation
    # with the returned incumbent; both engines must land on the same
    # canonical answer.
    monkeypatch.setattr(tp, "NODE_BUDGET", 5)
    monkeypatch.setattr(segenum_mod, "CLOSURE_CAP", 1)
    rng = np.random.default_rng(seed + 5300)
    N = int(rng.integers(6, 30))
    M = int(rng.integers(2, 12))
    inst = attach_flat(random_instance(rng, N, M))
    kind_res = solve_round_native(inst, 60.0, 5)
    assert kind_res is not None
    got = tp.solve_two_phase(inst, 60.0)
    want = solve_python_chain(inst, 60.0)
    assert_same(got, want)


@pytest.mark.parametrize("seed", range(10))
def test_round_native_matches_chain_wide_mi(seed, monkeypatch):
    """64 < Mi <= 128 (the two-word closure): the consolidated native
    call (u128 closure + enum) and the pure-Python chain (word-array
    _PerStructure + Python-int closure) must stay bit-identical across
    whatever escalation the content picks (closure OPTIMAL, closure
    declined -> LP/full, ...)."""
    monkeypatch.setattr(tp, "NODE_BUDGET", 5)  # force past phase 1
    rng = np.random.default_rng(seed + 5400)
    N = int(rng.integers(6, 32))
    M = int(rng.integers(65, 129))
    inst = attach_flat(random_instance(rng, N, M))
    got = tp.solve_two_phase(inst, 60.0)
    want = solve_python_chain(inst, 60.0)
    assert got.status == "OPTIMAL"
    assert_same(got, want)


@pytest.mark.parametrize("seed", range(6))
def test_wide_mi_closure_objective_is_optimal(seed, monkeypatch):
    """The two-word closure's objective equals the unbudgeted exact
    read-DFS optimum (engines may tie-break differently among equally
    optimal solutions; the objective is the optimality witness)."""
    from freddie_jax.solver.exact import solve_exact

    monkeypatch.setattr(tp, "NODE_BUDGET", 5)
    rng = np.random.default_rng(seed + 5500)
    N = int(rng.integers(4, 16))
    M = int(rng.integers(65, 129))
    inst = attach_flat(random_instance(rng, N, M))
    got = tp.solve_two_phase(inst, 60.0)
    full = solve_exact(inst, 120.0)
    assert got.status == full.status == "OPTIMAL"
    assert got.objective == full.objective


def test_round_native_empty_instance():
    rng = np.random.default_rng(0)
    inst = attach_flat(random_instance(rng, 2, 3))
    inst.rows = []
    inst.exons_mat = np.zeros((0, 3), dtype=bool)
    inst.corr_mat = np.zeros((0, 3), dtype=bool)
    inst.garbage_arr = np.zeros(0, dtype=np.float64)
    inst.gap_counts = np.zeros(0, dtype=np.int32)
    inst.gap_lo = np.zeros(0, dtype=np.int32)
    inst.gap_hi = np.zeros(0, dtype=np.int32)
    inst.gap_len_arr = np.zeros(0, dtype=np.int64)
    inst.incomp = []
    kind, res = solve_round_native(inst, 60.0, 100)
    assert kind == "final" and res.status == "OPTIMAL" and res.objective == 0.0


def test_device_bounds_match_host_and_gate_roundtrip(monkeypatch):
    """The batched matmul bound evaluation must be bit-equal to the host
    loop, and the closure_device escalation (C++ defers, Python re-runs
    the closure with device bounds) must return exactly what the
    all-native path returns."""
    import freddie_jax.solver.segenum as se
    from freddie_jax.solver.segenum import (
        _PerStructure,
        _optimistic_masks_device,
    )

    rng = np.random.default_rng(4242)
    for _ in range(10):
        N = int(rng.integers(2, 60))
        M = int(rng.integers(2, 14))
        inst = attach_flat(random_instance(rng, N, M))
        ctx = _PerStructure(inst)
        masks = np.unique(
            rng.integers(0, 1 << M, size=200).astype(np.uint64)
        )
        want = ctx.optimistic_block(masks)
        got = _optimistic_masks_device(ctx, masks)
        assert np.array_equal(got, want)

    # Round-trip: force the gate to 1 so every escalating instance takes
    # the closure_device path; results must equal the ungated solve.
    monkeypatch.setattr(tp, "NODE_BUDGET", 5)
    for seed in range(6):
        rng = np.random.default_rng(seed + 6400)
        inst = attach_flat(random_instance(rng, int(rng.integers(6, 30)),
                                           int(rng.integers(2, 12))))
        want = tp.solve_two_phase(inst, 60.0)
        monkeypatch.setattr(se, "BOUNDS_DEVICE_MIN", 1)
        got = tp.solve_two_phase(inst, 60.0)
        monkeypatch.setattr(se, "BOUNDS_DEVICE_MIN", 20_000_000)
        assert_same(got, want)
