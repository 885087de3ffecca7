"""LP-assisted two-phase exact solve.

Phase 1 runs the branch-and-bound with a deterministic node budget. If it
finishes, done. Otherwise the escalation chain (all exact, all gated
purely on instance content): union-closure structure enumeration at any
Mi <= 128 (one- or two-word masks, chosen by Mi alone) -- filtered and
DFS-floor-seeded by the phase-1 incumbent --
then full 2^Mi enumeration (Mi <= 20) or the XLA bound-filtered wide
path (Mi <= 26) when the closure is over its cap. If every enumeration
declines, the LP relaxation (solver.lp_bound) can prove the phase-1
incumbent optimal: when the LP lower bound shows no solution can be
strictly better (objective values are multiples of the instance's
granularity), the incumbent is returned as OPTIMAL -- this can only stop
the search with the result it would have returned anyway (strict-
improvement incumbent updates), so determinism and the canonical optimum
are preserved. When the LP does not close the gap, phase 2 re-runs the
full search under the wall-clock deadline (the reference's Gurobi
TimeLimit analog, py/freddie_cluster.py:581).
"""

from __future__ import annotations

import time

from .exact import ClusterInstance, SolveResult, solve_exact
from .lp_bound import lp_lower_bound
from .native import solve_exact_native

# Phase-1 budget: easy instances finish well under this; hard ones
# escalate quickly to the (native) structure enumeration. The value is
# part of the deterministic output contract (it decides which engine's
# equally-optimal tie-break an instance gets), so changes require a
# deliberate golden-fixture regeneration (tests/test_golden.py recipe).
# History: 50k -> 10k in round 2 (15.1 -> 8.8 s single-thread on the
# bench dataset -- pre-consolidation, escalations paid Python
# marshalling, so strong incumbents were precious). Round 3's
# consolidated C++ escalation (native/round_solver.cpp) made the
# closure rung cheap, flipping the trade: on the 300k corpus
# (400 tints, single-thread) 10k/5k/2k/1k/500 nodes measure
# 29.1/26.5/24.8/22.7/21.2 s with zero timeouts throughout. 1k keeps a
# margin against pathological instances where the phase-1 incumbent is
# the only effective closure filter; 500 buys 6% more for double the
# incumbent risk.
NODE_BUDGET = 1_000


def _objective_granularity(inst: ClusterInstance) -> float:
    """Objective values are sums of integers (corrections) and garbage
    costs; with the reference's cost models garbage is integral
    ('constant') or half-integral ('exons'/'introns')."""
    if all(float(r.garbage).is_integer() for r in inst.rows):
        return 1.0
    return 0.5


def _solve_raw(inst, deadline_s, node_budget=0) -> SolveResult:
    res = solve_exact_native(inst, deadline_s, node_budget)
    if res is not None:
        return res
    return solve_exact(inst, deadline_s, node_budget)


def solve_two_phase(inst: ClusterInstance, deadline_s: float = 60.0) -> SolveResult:
    t0 = time.monotonic()
    # Consolidated native fast path: phase 1 + the union-closure
    # escalation in one call (native/round_solver.cpp), bit-equal to the
    # rung-by-rung chain below (tests/test_round_native.py). Returns None
    # when the toolchain or the flat instance arrays are unavailable --
    # then the Python chain runs with identical results (every dispatch
    # gate is content-only in both).
    from .native import solve_round_native

    nr = solve_round_native(inst, deadline_s, NODE_BUDGET)
    if nr is not None:
        kind, res = nr
        if kind == "final":
            return res
        # 'budget': closure declined on content (Mi out of range or
        # closure over cap) -- run escalations 1b/1c below.
        # 'closure_timeout': the closure replay hit the wall -- skip
        # straight to the LP proof / full search (the Python chain does
        # the same when closure_res is non-None and non-OPTIMAL).
        # 'closure_device': N*closure crosses the device-bounds gate --
        # run the Python closure escalation (its bound evaluation goes
        # to the batched XLA matmul; values bit-equal, so the canonical
        # result matches the all-native path).
        if kind != "closure_device":
            return _escalate(
                inst, res, t0, deadline_s, try_enum=(kind == "budget")
            )
    else:
        res = _solve_raw(inst, deadline_s, NODE_BUDGET)
        if res.status != "BUDGET":
            return res
    # Escalation 1a: enumerate the union closure of the reads' I-masks --
    # exactly the coverable structures, so the canonical answer equals
    # full enumeration's at ANY Mi (equivalence proof in
    # solve_segment_enum_closure) -- and typically orders of magnitude
    # fewer structures than 2^Mi, each one skipping a conflict DFS.
    # Content-only gate (Mi <= CLOSURE_MAX_SEGS + closure-size cap).
    # The phase-1 incumbent (always feasible -- assign-nothing at worst)
    # prunes closure members that cannot reach the optimum.
    from .segenum import solve_segment_enum_closure

    remaining = max(deadline_s - (time.monotonic() - t0), 1.0)
    closure_res = solve_segment_enum_closure(
        inst, remaining, incumbent_cost=res.objective
    )
    if closure_res is not None and closure_res.status == "OPTIMAL":
        return closure_res
    return _escalate(inst, res, t0, deadline_s, try_enum=closure_res is None)


def _escalate(
    inst: ClusterInstance,
    res: SolveResult,
    t0: float,
    deadline_s: float,
    try_enum: bool,
) -> SolveResult:
    """Escalations past the union closure, shared by the consolidated
    native path and the rung-by-rung chain. `res` is the phase-1
    incumbent; `try_enum` runs 1b/1c (only when the closure DECLINED on
    content -- when it ran and timed out, the Python chain skips them
    too)."""
    from .segenum import solve_segment_enum, solve_segment_enum_wide

    if try_enum:
        # Escalation 1b: full 2^Mi structure enumeration for Mi <=
        # MAX_SEGS (the closure was over the cap or Mi = 0). Declines
        # purely on instance content, identical with or without the
        # native toolchain.
        remaining = max(deadline_s - (time.monotonic() - t0), 1.0)
        enum_res = solve_segment_enum(inst, remaining)
        if enum_res is not None and enum_res.status == "OPTIMAL":
            return enum_res
        # Escalation 1c: for Mi in (MAX_SEGS, WIDE_MAX_SEGS] with an
        # oversized closure, the XLA-assisted bound-filtered enumeration
        # (content-only gate; the kernel computes identical exact values
        # on GPU or CPU). The phase-1 incumbent is a valid upper bound
        # for the mask filter. Same canonical answer as 1a/1b when they
        # complete, so the ordering only changes speed.
        if enum_res is None:
            remaining = max(deadline_s - (time.monotonic() - t0), 1.0)
            wide_res = solve_segment_enum_wide(inst, res.objective, remaining)
            if wide_res is not None and wide_res.status == "OPTIMAL":
                return wide_res
    # Escalation 2: LP bound proof of the phase-1 incumbent.
    gran = _objective_granularity(inst)
    bound = lp_lower_bound(inst)
    if bound is not None and bound > res.objective - gran + 1e-4:
        # No strictly better solution exists; the incumbent is the same
        # one the full search would return.
        return SolveResult("OPTIMAL", res.objective, res.assigned, res.isoform, res.nodes)
    # Escalation 3: full search under the remaining deadline.
    remaining = max(deadline_s - (time.monotonic() - t0), 1.0)
    return _solve_raw(inst, remaining)
