"""Native (C++) structure-enumeration solver vs the Python twin:
bit-identical results."""

import numpy as np
import pytest

from freddie_jax.solver.native import native_available, solve_segenum_native
from freddie_jax.solver.segenum import _solve_segment_enum_py
from tests.test_solver import random_instance

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no C++ toolchain available"
)


@pytest.mark.parametrize("seed", range(15))
def test_native_matches_python(seed):
    rng = np.random.default_rng(seed + 2400)
    N = int(rng.integers(2, 40))
    M = int(rng.integers(1, 13))
    inst = random_instance(rng, N, M)
    py = _solve_segment_enum_py(inst)
    nat = solve_segenum_native(inst)
    assert nat is not None and py is not None
    assert nat.status == py.status == "OPTIMAL"
    assert nat.objective == py.objective
    assert nat.assigned == py.assigned
    assert np.array_equal(np.asarray(nat.isoform), np.asarray(py.isoform))


def test_native_declines_large_mi():
    rng = np.random.default_rng(1)
    inst = random_instance(rng, 4, 25)
    assert solve_segenum_native(inst) is None


def test_native_extended_mi_matches_dfs_value():
    # Mi in 17..20: value must equal the read-DFS optimum.
    from freddie_jax.solver.exact import solve_exact

    rng = np.random.default_rng(7)
    inst = random_instance(rng, 8, 18)
    nat = solve_segenum_native(inst)
    dfs = solve_exact(inst)
    assert nat is not None and nat.status == dfs.status == "OPTIMAL"
    assert nat.objective == dfs.objective


@pytest.mark.parametrize("seed", [2, 3])  # Mi=20 and Mi=17 instances
def test_twins_bit_equal_extended_mi(seed):
    # Dispatch is content-only: the Python twin must cover the full
    # Mi <= MAX_SEGS range (17..20 included) bit-identically to the C++
    # core, so a missing toolchain never changes the escalation path.
    rng = np.random.default_rng(seed + 3100)
    N = int(rng.integers(4, 16))
    M = int(rng.integers(17, 21))
    inst = random_instance(rng, N, M)
    py = _solve_segment_enum_py(inst, deadline_s=120.0)
    nat = solve_segenum_native(inst, deadline_s=120.0)
    assert nat is not None and py is not None
    assert nat.status == py.status == "OPTIMAL"
    assert nat.objective == py.objective
    assert nat.assigned == py.assigned
    assert np.array_equal(np.asarray(nat.isoform), np.asarray(py.isoform))
