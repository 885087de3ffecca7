"""Wide (bound-filtered, XLA-assisted) structure enumeration for
Mi in (MAX_SEGS, WIDE_MAX_SEGS]: must reproduce full enumeration's
canonical answer exactly and match the read-DFS optimum value.

Canonical-equivalence tests lower MAX_SEGS so the wide path activates on
instances small enough for the full-enumeration oracle; genuinely large
instances (Mi 21..23) are covered against the read-DFS optimum value."""

import numpy as np
import pytest

from freddie_jax.solver import segenum
from freddie_jax.solver.exact import solve_exact
from freddie_jax.solver.segenum import (
    _solve_segment_enum_py,
    solve_segment_enum_wide,
)
from tests.test_solver import random_instance


@pytest.mark.parametrize("seed", range(8))
def test_wide_matches_full_enumeration_canon(seed, monkeypatch):
    """Filter + replay must return exactly what full enumeration returns,
    including the tie-break canon, across filter tightness levels."""
    rng = np.random.default_rng(seed + 5100)
    N = int(rng.integers(4, 20))
    M = int(rng.integers(10, 14))
    inst = random_instance(rng, N, M)
    full = _solve_segment_enum_py(inst, deadline_s=120.0)  # real cap: M <= 20
    assert full is not None and full.status == "OPTIMAL"
    monkeypatch.setattr(segenum, "MAX_SEGS", 8)  # activates wide for this M
    for slack in (0.0, 1.0, 10.0):
        wide = solve_segment_enum_wide(inst, full.objective + slack, deadline_s=120.0)
        assert wide is not None and wide.status == "OPTIMAL", slack
        assert wide.objective == full.objective
        assert wide.assigned == full.assigned
        assert np.array_equal(np.asarray(wide.isoform), np.asarray(full.isoform))


def clustered_instance(rng, N, M, k_true=3):
    """Reads clustered around a few true exon structures with small
    corrections -- the shape real Mi>20 instances take (many reads, few
    underlying isoforms), where the optimistic filter bites hard."""
    from freddie_jax.solver.exact import ClusterInstance, ReadRow

    trues = [rng.random(M) < 0.5 for _ in range(k_true)]
    rows = []
    for _ in range(N):
        base = trues[int(rng.integers(k_true))].copy()
        corr = np.zeros(M, dtype=bool)
        for j in np.flatnonzero(rng.random(M) < 0.08):
            if base[j]:
                base[j] = False
                corr[j] = True  # correctable dropped exon
        rows.append(ReadRow(exons=base, corr=corr,
                            garbage=3.0 * float(rng.integers(1, 4)), gaps=[]))
    return ClusterInstance(rows=rows, seg_len=rng.integers(50, 2000, size=M),
                           incomp=[], epsilon=0.2, offset=20)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wide_large_mi_matches_dfs_value(seed):
    rng = np.random.default_rng(seed + 6200)
    if seed == 0:
        N = int(rng.integers(4, 10))
        M = int(rng.integers(21, 24))
        inst = random_instance(rng, N, M)
    else:
        inst = clustered_instance(rng, N=20, M=21 + seed)
        M = 21 + seed
        N = 20
    dfs = solve_exact(inst, deadline_s=120.0)
    assert dfs.status == "OPTIMAL"
    wide = solve_segment_enum_wide(inst, dfs.objective, deadline_s=120.0)
    assert wide is not None and wide.status == "OPTIMAL"
    assert wide.objective == dfs.objective
    # returned solution reproduces its objective and respects constraints
    E = np.zeros(M, dtype=bool)
    for i in wide.assigned:
        E |= inst.rows[i].exons
    if wide.assigned:
        assert np.array_equal(E, np.asarray(wide.isoform))
    obj = sum(
        int(np.count_nonzero(inst.rows[i].corr & E))
        if i in wide.assigned
        else inst.rows[i].garbage
        for i in range(N)
    )
    assert obj == wide.objective
    for a, b in inst.incomp:
        assert not (a in wide.assigned and b in wide.assigned)


def test_wide_declines_out_of_range():
    rng = np.random.default_rng(3)
    inst_small = random_instance(rng, 5, 10)  # Mi <= MAX_SEGS: not wide's job
    assert solve_segment_enum_wide(inst_small, 100.0) is None
    inst_huge = random_instance(rng, 5, 30)  # beyond WIDE_MAX_SEGS
    assert solve_segment_enum_wide(inst_huge, 100.0) is None


def test_wide_deterministic():
    rng = np.random.default_rng(9)
    inst = random_instance(rng, 8, 22)
    dfs = solve_exact(inst, deadline_s=120.0)
    a = solve_segment_enum_wide(inst, dfs.objective, deadline_s=120.0)
    b = solve_segment_enum_wide(inst, dfs.objective, deadline_s=120.0)
    assert a is not None and b is not None
    assert a.objective == b.objective and a.assigned == b.assigned


def test_two_phase_uses_wide_escalation(monkeypatch):
    """An instance above the (lowered) enumeration cap whose read-DFS
    exhausts the node budget and whose union closure exceeds the (zeroed)
    cap must be solved optimally via the wide escalation -- dispatch by
    content, no availability gate."""
    from freddie_jax.solver import two_phase as tp

    rng = np.random.default_rng(11)
    inst = random_instance(rng, 16, 12)
    want = solve_exact(inst, deadline_s=120.0)
    assert want.status == "OPTIMAL"
    calls = []
    real_wide = segenum.solve_segment_enum_wide

    def spy(inst_, inc, deadline_s=60.0):
        calls.append(inc)
        return real_wide(inst_, inc, deadline_s)

    monkeypatch.setattr(segenum, "MAX_SEGS", 8)
    monkeypatch.setattr(segenum, "CLOSURE_CAP", 0)  # force past closure
    monkeypatch.setattr(segenum, "solve_segment_enum_wide", spy)
    monkeypatch.setattr(tp, "NODE_BUDGET", 1)  # force the escalation
    res = tp.solve_two_phase(inst, deadline_s=120.0)
    assert res.status == "OPTIMAL" and res.objective == want.objective
    assert calls, "wide escalation was not attempted"


def test_two_phase_uses_closure_escalation(monkeypatch):
    """Same setup without the closure cap: the union-closure escalation
    fires first and returns the identical canonical answer."""
    from freddie_jax.solver import two_phase as tp

    rng = np.random.default_rng(11)
    inst = random_instance(rng, 16, 12)
    want = _solve_segment_enum_py(inst, deadline_s=120.0)
    assert want.status == "OPTIMAL"
    calls = []
    real = segenum.solve_segment_enum_closure

    def spy(inst_, deadline_s=60.0, incumbent_cost=None):
        res = real(inst_, deadline_s, incumbent_cost=incumbent_cost)
        calls.append(res)
        return res

    monkeypatch.setattr(segenum, "MAX_SEGS", 8)
    monkeypatch.setattr(segenum, "solve_segment_enum_closure", spy)
    monkeypatch.setattr(tp, "NODE_BUDGET", 1)
    res = tp.solve_two_phase(inst, deadline_s=120.0)
    assert calls and calls[0] is not None, "closure escalation did not fire"
    assert res.status == "OPTIMAL"
    assert res.objective == want.objective
    assert res.assigned == want.assigned
    assert np.array_equal(np.asarray(res.isoform), np.asarray(want.isoform))
