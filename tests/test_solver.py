"""Exact cluster solver vs brute-force enumeration."""

import numpy as np
import pytest

from freddie_jax.solver.brute import brute_force_optimum
from freddie_jax.solver.exact import ClusterInstance, ReadRow, solve_exact


def random_instance(rng, N, M, with_gaps=True, with_incomp=True):
    seg_len = rng.integers(20, 500, size=M).astype(np.int64)
    rows = []
    for _ in range(N):
        # structured exon rows: a contiguous covered span with dropouts
        f = int(rng.integers(0, M))
        l = int(rng.integers(f, M))
        exons = np.zeros(M, dtype=bool)
        exons[f : l + 1] = rng.random(l + 1 - f) > 0.3
        corr = np.zeros(M, dtype=bool)
        corr[f : l + 1] = (~exons[f : l + 1]) & (rng.random(l + 1 - f) > 0.4)
        gaps = []
        if with_gaps and rng.random() < 0.5 and M > 2:
            j1 = int(rng.integers(0, M - 2))
            j2 = int(rng.integers(j1 + 2, M))
            mask = np.zeros(M, dtype=bool)
            mask[j1 + 1 : j2] = True
            l_obs = int(rng.integers(0, 400))
            gaps.append((mask, l_obs))
        rows.append(
            ReadRow(
                exons=exons,
                corr=corr,
                garbage=float(rng.integers(1, 4) * 3),
                gaps=gaps,
            )
        )
    incomp = []
    if with_incomp:
        for _ in range(rng.integers(0, 3)):
            a, b = sorted(rng.choice(N, size=2, replace=False).tolist())
            incomp.append((int(a), int(b)))
    return ClusterInstance(rows=rows, seg_len=seg_len, incomp=incomp)


@pytest.mark.parametrize("seed", range(10))
def test_exact_matches_brute(seed):
    rng = np.random.default_rng(seed)
    N = int(rng.integers(2, 11))
    M = int(rng.integers(2, 7))
    inst = random_instance(rng, N, M)
    res = solve_exact(inst)
    assert res.status == "OPTIMAL"
    want = brute_force_optimum(inst)
    assert res.objective == want, (res.objective, want)
    # the reported assignment must reproduce the reported objective
    E = np.zeros(M, dtype=bool)
    for i in res.assigned:
        E |= inst.rows[i].exons
    obj = sum(
        int(np.count_nonzero(inst.rows[i].corr & E))
        if i in res.assigned
        else inst.rows[i].garbage
        for i in range(N)
    )
    assert obj == res.objective


def test_empty_and_trivial():
    inst = ClusterInstance(rows=[], seg_len=np.array([10]), incomp=[])
    res = solve_exact(inst)
    assert res.status == "OPTIMAL" and res.objective == 0.0

    # One read, no corrections: assigning costs 0 < garbage.
    rows = [
        ReadRow(
            exons=np.array([True, False]),
            corr=np.zeros(2, dtype=bool),
            garbage=3.0,
            gaps=[],
        )
    ]
    res = solve_exact(ClusterInstance(rows=rows, seg_len=np.array([10, 10]), incomp=[]))
    assert res.assigned == [0] and res.objective == 0.0


def test_incompatible_pair_never_together():
    rows = []
    for _ in range(2):
        rows.append(
            ReadRow(
                exons=np.array([True, True]),
                corr=np.zeros(2, dtype=bool),
                garbage=3.0,
                gaps=[],
            )
        )
    inst = ClusterInstance(
        rows=rows, seg_len=np.array([10, 10]), incomp=[(0, 1)]
    )
    res = solve_exact(inst)
    assert len(res.assigned) == 1 and res.objective == 3.0


def test_gap_constraint_excludes_read():
    # Read 1 has a gap requiring ~100bp of skipped exon; read 0 forces the
    # in-between exon (len 500) on, making read 1's gap infeasible with it.
    rows = [
        ReadRow(
            exons=np.array([True, True, True]),
            corr=np.zeros(3, dtype=bool),
            garbage=30.0,
            gaps=[],
        ),
        ReadRow(
            exons=np.array([True, False, True]),
            corr=np.array([False, True, False]),
            garbage=3.0,
            gaps=[(np.array([False, True, False]), 100)],
        ),
    ]
    seg_len = np.array([100, 500, 100], dtype=np.int64)
    res = solve_exact(ClusterInstance(rows=rows, seg_len=seg_len, incomp=[]))
    # (1-0.2)*500 - 20 = 380 > 100 -> read 1 cannot join once E includes
    # the middle exon; assigning only read 0 costs garbage(1)=3.
    assert res.assigned == [0]
    assert res.objective == 3.0
    # Alone, read 1's gap against E without the middle exon: G=0,
    # 0 <= 100 <= 0*1.2+20? No -> also infeasible; check solver agrees
    res2 = solve_exact(
        ClusterInstance(rows=[rows[1]], seg_len=seg_len, incomp=[])
    )
    assert res2.assigned == []
