"""Dense-conflict instances: the regime where the clique-cover bounds
matter (production timeouts live here -- ~200 reads with 50-100% of all
pairs incompatible). The bounds are result-preserving by construction;
these tests pin that down: exact twins stay bit-equal, the wide path's
native replay equals the Python replay, and segenum still matches the
read-DFS optimum under heavy conflict load."""

import numpy as np
import pytest

from freddie_jax.solver.exact import ClusterInstance, ReadRow, solve_exact
from freddie_jax.solver.native import (
    native_available,
    solve_exact_native,
    solve_segenum_native,
)
from freddie_jax.solver.segenum import (
    _solve_segment_enum_py,
    solve_segment_enum_wide,
)


def dense_instance(rng, N, M, density=0.6, k_true=3):
    """Few true structures, many near-duplicate reads, dense random
    incompatibilities -- the shape of the production timeout instances."""
    trues = [rng.random(M) < 0.5 for _ in range(k_true)]
    rows = []
    for _ in range(N):
        base = trues[int(rng.integers(k_true))].copy()
        corr = np.zeros(M, dtype=bool)
        for j in np.flatnonzero(rng.random(M) < 0.1):
            if base[j]:
                base[j] = False
                corr[j] = True
        rows.append(
            ReadRow(
                exons=base,
                corr=corr,
                garbage=3.0 * float(rng.integers(1, 5)),
                gaps=[],
            )
        )
    incomp = []
    for a in range(N):
        for b in range(a + 1, N):
            if rng.random() < density:
                incomp.append((a, b))
    return ClusterInstance(
        rows=rows, seg_len=rng.integers(50, 2000, size=M), incomp=incomp
    )


@pytest.mark.parametrize("seed", range(6))
def test_exact_twins_dense(seed):
    """C++ and Python read-DFS agree bit-for-bit (status, objective,
    assignment, node count) on dense-conflict instances -- node-count
    equality is what keeps BUDGET escalation platform-independent."""
    if not native_available():
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(seed + 7100)
    N = int(rng.integers(10, 28))
    M = int(rng.integers(4, 40))
    inst = dense_instance(rng, N, M, density=float(rng.uniform(0.3, 0.9)))
    py = solve_exact(inst, deadline_s=60.0)
    nat = solve_exact_native(inst, deadline_s=60.0)
    assert nat.status == py.status == "OPTIMAL"
    assert nat.objective == py.objective
    assert nat.assigned == py.assigned
    assert nat.nodes == py.nodes


@pytest.mark.parametrize("seed", range(6))
def test_exact_twins_dense_budget(seed):
    """Same node path under a node budget: the BUDGET incumbent (which
    feeds the escalation chain) must be identical across engines."""
    if not native_available():
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(seed + 7200)
    inst = dense_instance(rng, 24, 30, density=0.7)
    for budget in (50, 500, 5000):
        py = solve_exact(inst, deadline_s=60.0, node_budget=budget)
        nat = solve_exact_native(inst, deadline_s=60.0, node_budget=budget)
        assert nat.status == py.status, budget
        assert nat.objective == py.objective, budget
        assert nat.assigned == py.assigned, budget
        assert nat.nodes == py.nodes, budget


@pytest.mark.parametrize("seed", range(4))
def test_segenum_twins_dense(seed):
    """Structure-enumeration twins on dense conflicts (per-structure DFS
    with the clique bound on both sides)."""
    if not native_available():
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(seed + 7300)
    N = int(rng.integers(10, 30))
    M = int(rng.integers(4, 13))
    inst = dense_instance(rng, N, M, density=0.7)
    py = _solve_segment_enum_py(inst, deadline_s=60.0)
    nat = solve_segenum_native(inst, deadline_s=60.0)
    assert py.status == nat.status == "OPTIMAL"
    assert nat.objective == py.objective
    assert nat.assigned == py.assigned
    # and both match the read-DFS optimum value
    dfs = solve_exact(inst, deadline_s=60.0)
    assert dfs.objective == py.objective


@pytest.mark.parametrize("seed", range(4))
def test_wide_native_replay_equals_python(seed, monkeypatch):
    """The wide path's C++ replay returns exactly what the Python replay
    returns on the same filtered mask list (dense conflicts included)."""
    if not native_available():
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(seed + 7400)
    inst = dense_instance(rng, 16, 22, density=0.6)
    dfs = solve_exact(inst, deadline_s=60.0)
    native = solve_segment_enum_wide(inst, dfs.objective, deadline_s=120.0)
    assert native is not None and native.status == "OPTIMAL"
    import freddie_jax.solver.native as native_mod

    monkeypatch.setattr(native_mod, "solve_segenum_list_native", lambda *a, **k: None)
    pure = solve_segment_enum_wide(inst, dfs.objective, deadline_s=120.0)
    assert pure is not None and pure.status == "OPTIMAL"
    assert native.objective == pure.objective == dfs.objective
    assert native.assigned == pure.assigned
    assert np.array_equal(np.asarray(native.isoform), np.asarray(pure.isoform))


@pytest.mark.parametrize("seed", range(4))
def test_closure_large_mi_matches_dfs_value(seed):
    """Union-closure enumeration on Mi in (26, 45]: same optimum value as
    the read-DFS, constraint-valid assignment, objective reproducible."""
    from freddie_jax.solver.segenum import solve_segment_enum_closure

    rng = np.random.default_rng(seed + 8100)
    M = int(rng.integers(27, 46))
    inst = dense_instance(rng, 22, M, density=0.5)
    dfs = solve_exact(inst, deadline_s=120.0)
    assert dfs.status == "OPTIMAL"
    clo = solve_segment_enum_closure(inst, deadline_s=120.0)
    assert clo is not None and clo.status == "OPTIMAL"
    assert clo.objective == dfs.objective
    E = np.zeros(M, dtype=bool)
    for i in clo.assigned:
        E |= inst.rows[i].exons
    if clo.assigned:
        assert np.array_equal(E, np.asarray(clo.isoform))
    obj = sum(
        int(np.count_nonzero(inst.rows[i].corr & E))
        if i in clo.assigned
        else inst.rows[i].garbage
        for i in range(len(inst.rows))
    )
    assert obj == clo.objective
    for a, b in inst.incomp:
        assert not (a in clo.assigned and b in clo.assigned)


@pytest.mark.parametrize("seed", range(4))
def test_closure_equals_full_enumeration_canon(seed, monkeypatch):
    """On Mi small enough for the full-enumeration oracle, the closure
    path must return the identical canonical answer (objective,
    assignment, AND structure) -- the equivalence proof in its docstring,
    exercised end to end."""
    import freddie_jax.solver.segenum as segenum_mod

    rng = np.random.default_rng(seed + 8200)
    M = int(rng.integers(8, 14))
    inst = dense_instance(rng, 14, M, density=0.4)
    full = _solve_segment_enum_py(inst, deadline_s=120.0)
    assert full is not None and full.status == "OPTIMAL"
    monkeypatch.setattr(segenum_mod, "MAX_SEGS", 4)  # activate closure
    clo = segenum_mod.solve_segment_enum_closure(inst, deadline_s=120.0)
    assert clo is not None and clo.status == "OPTIMAL"
    assert clo.objective == full.objective
    assert clo.assigned == full.assigned
    assert np.array_equal(np.asarray(clo.isoform), np.asarray(full.isoform))
    # and the Python replay fallback agrees with the native replay
    import freddie_jax.solver.native as native_mod

    monkeypatch.setattr(native_mod, "solve_segenum_list_native", lambda *a, **k: None)
    pure = segenum_mod.solve_segment_enum_closure(inst, deadline_s=120.0)
    assert pure is not None and pure.status == "OPTIMAL"
    assert pure.objective == clo.objective
    assert pure.assigned == clo.assigned
    assert np.array_equal(np.asarray(pure.isoform), np.asarray(clo.isoform))


def test_closure_gates():
    """Content-only decline: Mi > CLOSURE_MAX_SEGS (128 since the
    two-word generalization) is not the closure path's job; small Mi now
    IS (it runs before full enumeration and returns the identical
    canonical result -- test_small_mi_closure)."""
    from freddie_jax.solver.segenum import solve_segment_enum_closure

    rng = np.random.default_rng(5)
    assert solve_segment_enum_closure(dense_instance(rng, 8, 130)) is None
    # 64 < Mi <= 128 is now in range (the two-word path).
    assert solve_segment_enum_closure(dense_instance(rng, 8, 70)) is not None


@pytest.mark.parametrize("seed", range(5))
def test_wide_mi_closure_native_equals_python_replay(seed):
    """64 < Mi <= 128: the native u128 replay and the Python word-array
    fallback must return the identical canonical result on dense
    near-duplicate instances (the shape the two-word rung exists for)."""
    import unittest.mock as mock

    import freddie_jax.solver.native as native_mod
    from freddie_jax.solver.segenum import solve_segment_enum_closure

    rng = np.random.default_rng(seed + 9100)
    mi = int(rng.integers(65, 129))
    n = int(rng.integers(10, 40))
    inst = dense_instance(rng, n, mi)
    a = solve_segment_enum_closure(inst)
    with mock.patch.object(
        native_mod, "solve_segenum_list_native", lambda *ar, **kw: None
    ):
        b = solve_segment_enum_closure(inst)
    assert a is not None and b is not None
    assert (a.status, a.objective, a.assigned) == (
        b.status, b.objective, b.assigned
    )
    assert (np.asarray(a.isoform) == np.asarray(b.isoform)).all()


def test_small_mi_closure_equals_full_enum():
    """At Mi <= MAX_SEGS the closure path must return exactly what full
    2^Mi enumeration returns (same optimum, same canonical tie-break)."""
    from freddie_jax.solver.segenum import (
        solve_segment_enum,
        solve_segment_enum_closure,
    )

    rng = np.random.default_rng(7)
    for trial in range(12):
        mi = int(rng.integers(3, 13))
        n = int(rng.integers(5, 40))
        inst = dense_instance(rng, n, mi)
        a = solve_segment_enum_closure(inst)
        b = solve_segment_enum(inst)
        assert a is not None and b is not None
        assert (a.status, a.objective, a.assigned) == (
            b.status, b.objective, b.assigned
        )
        assert (a.isoform == b.isoform).all()
