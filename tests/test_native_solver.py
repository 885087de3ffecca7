"""Native (C++) B&B core vs the Python implementation: identical results."""

import numpy as np
import pytest

from freddie_jax.solver.exact import solve_exact
from freddie_jax.solver.native import native_available, solve_exact_native
from tests.test_solver import random_instance

pytestmark = pytest.mark.skipif(
    not native_available(), reason="no C++ toolchain available"
)


@pytest.mark.parametrize("seed", range(12))
def test_native_matches_python(seed):
    rng = np.random.default_rng(seed + 100)
    N = int(rng.integers(2, 30))
    M = int(rng.integers(1, 80))
    inst = random_instance(rng, N, M)
    py = solve_exact(inst)
    nat = solve_exact_native(inst)
    assert nat is not None
    assert nat.status == py.status == "OPTIMAL"
    assert nat.objective == py.objective
    assert nat.assigned == py.assigned
    if py.isoform is not None:
        assert np.array_equal(np.asarray(nat.isoform), np.asarray(py.isoform))


def test_native_empty():
    from freddie_jax.solver.exact import ClusterInstance

    inst = ClusterInstance(rows=[], seg_len=np.array([1]), incomp=[])
    nat = solve_exact_native(inst)
    assert nat.status == "OPTIMAL" and nat.objective == 0.0
