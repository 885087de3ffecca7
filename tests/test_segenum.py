"""Segment-enumeration solver: optimality vs brute force and the read-DFS."""

import numpy as np
import pytest

from freddie_jax.solver.brute import brute_force_optimum
from freddie_jax.solver.exact import ClusterInstance, ReadRow, solve_exact
from freddie_jax.solver.segenum import solve_segment_enum
from tests.test_solver import random_instance


@pytest.mark.parametrize("seed", range(12))
def test_matches_brute_force(seed):
    rng = np.random.default_rng(seed + 1300)
    N = int(rng.integers(2, 11))
    M = int(rng.integers(1, 7))
    inst = random_instance(rng, N, M)
    res = solve_segment_enum(inst)
    assert res is not None and res.status == "OPTIMAL"
    want = brute_force_optimum(inst)
    assert res.objective == want, (res.objective, want)
    # returned solution must reproduce the objective and be feasible
    E = np.zeros(M, dtype=bool)
    for i in res.assigned:
        E |= inst.rows[i].exons
    if res.assigned:
        assert np.array_equal(E, np.asarray(res.isoform))
    obj = sum(
        int(np.count_nonzero(inst.rows[i].corr & E))
        if i in res.assigned
        else inst.rows[i].garbage
        for i in range(N)
    )
    assert obj == res.objective
    for a, b in inst.incomp:
        assert not (a in res.assigned and b in res.assigned)


@pytest.mark.parametrize("seed", range(8))
def test_matches_read_dfs_value(seed):
    rng = np.random.default_rng(seed + 1700)
    N = int(rng.integers(2, 30))
    M = int(rng.integers(1, 15))
    inst = random_instance(rng, N, M)
    enum_res = solve_segment_enum(inst)
    dfs_res = solve_exact(inst)
    assert enum_res.status == dfs_res.status == "OPTIMAL"
    assert enum_res.objective == dfs_res.objective


def test_declines_large_instances():
    rng = np.random.default_rng(0)
    inst = random_instance(rng, 5, 25)  # beyond even the C++ core's Mi=20
    assert solve_segment_enum(inst) is None


def test_deterministic():
    rng = np.random.default_rng(9)
    inst = random_instance(rng, 20, 10)
    a = solve_segment_enum(inst)
    b = solve_segment_enum(inst)
    assert a.objective == b.objective and a.assigned == b.assigned
    assert np.array_equal(np.asarray(a.isoform), np.asarray(b.isoform))
