"""LP bound validity + two-phase solver equivalence."""

import numpy as np
import pytest

from freddie_jax.solver.brute import brute_force_optimum
from freddie_jax.solver.exact import solve_exact
from freddie_jax.solver.lp_bound import lp_lower_bound
from freddie_jax.solver.two_phase import solve_two_phase
from tests.test_solver import random_instance


@pytest.mark.parametrize("seed", range(8))
def test_lp_bound_is_valid(seed):
    rng = np.random.default_rng(seed + 500)
    N = int(rng.integers(2, 10))
    M = int(rng.integers(2, 7))
    inst = random_instance(rng, N, M)
    opt = brute_force_optimum(inst)
    bound = lp_lower_bound(inst)
    assert bound is not None
    assert bound <= opt + 1e-6, (bound, opt)


@pytest.mark.parametrize("seed", range(8))
def test_two_phase_matches_plain(seed):
    rng = np.random.default_rng(seed + 900)
    N = int(rng.integers(2, 25))
    M = int(rng.integers(2, 40))
    inst = random_instance(rng, N, M)
    plain = solve_exact(inst)
    two = solve_two_phase(inst)
    assert two.status == plain.status == "OPTIMAL"
    assert two.objective == plain.objective
    assert two.assigned == plain.assigned


def test_two_phase_with_tiny_budget(monkeypatch):
    # Force the budget path so the LP gets exercised on a solvable case.
    import freddie_jax.solver.two_phase as tp

    rng = np.random.default_rng(77)
    inst = random_instance(rng, 20, 30)
    want = solve_exact(inst)
    monkeypatch.setattr(tp, "NODE_BUDGET", 10)
    got = tp.solve_two_phase(inst)
    assert got.status == "OPTIMAL"
    assert got.objective == want.objective
    assert got.assigned == want.assigned
