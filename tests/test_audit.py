"""Optimum-uniqueness audit (solver/audit.py): classification sanity and
the closure-based candidate set that makes Mi > 26 instances decidable."""

import numpy as np
import pytest

from freddie_jax.solver.audit import audit_instance
from freddie_jax.solver.exact import ClusterInstance, ReadRow
from tests.test_dense_conflicts import dense_instance
from tests.test_solver import random_instance


def test_unique_simple():
    """Three identical reads, one structure: trivially unique."""
    rows = [
        ReadRow(
            exons=np.array([True, False]),
            corr=np.zeros(2, dtype=bool),
            garbage=3.0,
            gaps=[],
        )
        for _ in range(3)
    ]
    inst = ClusterInstance(rows=rows, seg_len=np.array([100, 50]), incomp=[])
    assert audit_instance(inst) == "unique"


def test_nonunique_symmetric():
    """Two symmetric single-read structures with equal cost: the optimum
    cannot be unique."""
    rows = [
        ReadRow(
            exons=np.array([True, False]),
            corr=np.zeros(2, dtype=bool),
            garbage=5.0,
            gaps=[],
        ),
        ReadRow(
            exons=np.array([False, True]),
            corr=np.zeros(2, dtype=bool),
            garbage=5.0,
            gaps=[],
        ),
    ]
    # the two reads conflict, so only one can be assigned -- two optima
    inst = ClusterInstance(
        rows=rows, seg_len=np.array([100, 100]), incomp=[(0, 1)]
    )
    assert audit_instance(inst) == "nonunique"


@pytest.mark.parametrize("seed", range(4))
def test_audit_consistent_with_solver(seed):
    """Whatever the classification, the audit must terminate and never
    contradict the solver (smoke over random instances)."""
    rng = np.random.default_rng(seed + 9100)
    inst = random_instance(rng, int(rng.integers(3, 12)), int(rng.integers(2, 16)))
    verdict = audit_instance(inst, deadline_s=30.0)
    assert verdict in ("unique", "nonunique", "unknown-timeout", "unknown-mi")


@pytest.mark.parametrize("seed", range(3))
def test_audit_decides_large_mi(seed):
    """Mi in (26, 45] instances -- formerly 'unknown-mi' -- are now
    decidable through the union-closure candidate set."""
    rng = np.random.default_rng(seed + 9200)
    M = int(rng.integers(27, 46))
    inst = dense_instance(rng, 18, M, density=0.5)
    verdict = audit_instance(inst, deadline_s=60.0)
    assert verdict in ("unique", "nonunique"), verdict
