"""Segmentation-DP equivalence tests.

A literal memoized-recursion oracle (mirroring the reference's recurrence at
py/freddie_segment.py:475-568, written independently) validates the
vectorized host solver; the batched device kernel is then checked against
the host solver on the same random instances, including mixed-size batches
with padding.
"""

import numpy as np
import pytest

from freddie_jax.ops.segdp import DPProblem, solve_batch_device, solve_host
from freddie_jax.ops.thresholds import ScaledThresholds


def literal_oracle(C, y, W, thr: ScaledThresholds, read_support: int):
    """Direct translation of the reference recurrence (float64, dicts)."""
    start, end = 0, len(y) - 1
    rate = thr.rate
    table = [v / thr.scale for v in thr.table_scaled.tolist()]

    def high(seg_len):
        return table[seg_len] if seg_len < len(table) else rate

    yea, nay, amb = {}, {}, {}
    for i in range(start, end):
        for j in range(i, end + 1):
            L = y[j] - y[i] + 1
            h = high(L)
            c = (C[j] - C[i]) / L
            yea[i, j] = c > h
            nay[i, j] = c < 1 - h
            amb[i, j] = W * np.logical_not(yea[i, j] | nay[i, j])

    def inside(i, j):
        return 0 if i == j else -amb[i, j].sum()

    def outside(i, j, k):
        if i == j or j == k:
            return 0
        v = (W * ((yea[i, j] & nay[j, k]) | (nay[i, j] & yea[j, k]))).sum()
        return float("-inf") if v < read_support else v

    D, B = {}, {}

    def dp(i, j, k):
        if (i, j, k) in D:
            return D[i, j, k]
        if y[j] - y[i] < 5 or y[k] - y[j] < 5:
            D[i, j, k], B[i, j, k] = float("-inf"), (-1, -1, -1)
        elif k == end:
            D[i, j, k] = inside(i, j) + outside(i, j, k) + inside(j, k)
            B[i, j, k] = (-1, -1, -1)
        else:
            best_d, best_b = float("-inf"), (-1, -1, -1)
            for k2 in range(k + 1, end + 1):
                d = inside(i, j) + outside(i, j, k) + dp(j, k, k2)
                if d > best_d:
                    best_d, best_b = d, (j, k, k2)
            D[i, j, k], B[i, j, k] = best_d, best_b
        return D[i, j, k]

    best_d = inside(start, end)
    best_b = (-1, -1, -1)
    for j in range(start + 1, end):
        for k in range(j + 1, end + 1):
            if dp(start, j, k) > best_d:
                best_b = (start, j, k)
                best_d = dp(start, j, k)
    out = set()
    b = best_b
    while b != (-1, -1, -1):
        out.update(b)
        b = B[b]
    return sorted(out)  # includes start/end when a segmentation was chosen


def random_problem(rng, P, R, span=2000):
    y = np.sort(rng.choice(np.arange(span), size=P, replace=False)).astype(np.int64)
    # Monotone cumulative coverage per rep with plateaus and jumps.
    inc = rng.integers(0, 12, size=(P, R))
    inc[rng.random(size=(P, R)) < 0.5] = 0
    C = np.cumsum(inc, axis=0).astype(np.int64)
    W = rng.integers(1, 5, size=R).astype(np.int64)
    return DPProblem(C=C, y=y, W=W, read_support=3)


@pytest.mark.parametrize("seed", range(6))
def test_host_matches_literal_oracle(seed):
    rng = np.random.default_rng(seed)
    thr = ScaledThresholds(0.9)
    P = int(rng.integers(3, 14))
    R = int(rng.integers(1, 9))
    pr = random_problem(rng, P, R)
    chain = solve_host(pr, thr)
    got = sorted(set(chain) | {0, P - 1}) if chain else []
    want = literal_oracle(pr.C, pr.y, pr.W, thr, pr.read_support)
    assert got == want


def test_device_matches_host_batched():
    rng = np.random.default_rng(42)
    thr = ScaledThresholds(0.9)
    problems = []
    for _ in range(17):
        P = int(rng.integers(2, 30))
        R = int(rng.integers(1, 40))
        problems.append(random_problem(rng, P, R))
    host = [solve_host(p, thr) for p in problems]
    dev = solve_batch_device(problems, thr)
    assert dev == host


def test_nay_equality_boundary():
    """A coverage ratio EXACTLY equal to 1-h must count as nay when the
    reference's float l = 1-h lands one ulp above the exact decimal
    (h=0.7 -> 1-0.7 = 0.30000000000000004), and the outside support sits
    exactly at read_support. Found by parity fuzzing (seed shift 47); the
    old strict integer comparison dropped this segmentation entirely."""
    thr = ScaledThresholds(0.9)
    # eq bit is per table entry: set for h=0.70 (seg_len 20), clear for
    # h=0.76 (seg_len 30) and for the 0.9 rate
    assert int(thr.nay_eq_scaled(np.array([20]))[0]) == 1
    assert int(thr.nay_eq_scaled(np.array([30]))[0]) == 0
    assert int(thr.nay_eq_scaled(np.array([200]))[0]) == 0
    y = np.array([0, 29, 48, 231], dtype=np.int64)
    # read 0: full on (0,1), ratio exactly 6/20 = 0.3 = 1-h on (1,2) ->
    # nay only via the equality bit; outside(0,1,2) is then exactly 3 = rs
    C = np.array([
        [0, 30, 36, 36],
        [0, 30, 30, 30],
        [0, 30, 30, 30],
        [0, 0, 0, 184],
        [0, 0, 0, 184],
        [0, 0, 0, 184],
    ], dtype=np.int64).T
    pr = DPProblem(C=C, y=y, W=np.ones(6, dtype=np.int64), read_support=3)
    want = literal_oracle(pr.C, pr.y, pr.W, thr, pr.read_support)
    assert want == [0, 1, 2, 3]  # the float-faithful oracle segments here
    chain = solve_host(pr, thr)
    assert sorted(set(chain) | {0, 3}) == want
    assert solve_batch_device([pr], thr) == [chain]


def test_degenerate_cases():
    thr = ScaledThresholds(0.9)
    # Too few candidates -> no segmentation.
    pr = DPProblem(
        C=np.zeros((2, 3), dtype=np.int64),
        y=np.array([0, 100], dtype=np.int64),
        W=np.ones(3, dtype=np.int64),
        read_support=3,
    )
    assert solve_host(pr, thr) == []
    assert solve_batch_device([pr], thr) == [[]]
    # All-small segments -> no segmentation possible.
    pr = DPProblem(
        C=np.tile(np.arange(5)[:, None], (1, 2)).astype(np.int64),
        y=np.array([0, 1, 2, 3, 4], dtype=np.int64),
        W=np.ones(2, dtype=np.int64),
        read_support=0,
    )
    assert solve_host(pr, thr) == []


def wide_weights(rng, R):
    """Rep weights past TF32's exact-integer range (2,048), up to the
    16,383 the device DP is specified for."""
    return rng.integers(1, 16384, size=R).astype(np.int64)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("P", [16, 32, 64])
def test_xla_kernel_matches_host(P, wide):
    """The production single-device jit (_solve_batch_jax, then the chain
    walk) at each P bucket edge, with narrow and with wide weights, is
    bit-identical to the host oracle."""
    import jax.numpy as jnp

    from chip_smoke import pad_batch
    from freddie_jax.ops.segdp import _get_jitted, collect_batch_device

    rng = np.random.default_rng(P + 1000 * wide)
    thr = ScaledThresholds(0.9)
    R = 24
    problems = []
    for _ in range(6):
        pr = random_problem(rng, int(rng.integers(P // 2 + 1, P + 1)), R,
                            span=40 * P)
        if wide:
            pr.W = wide_weights(rng, R)
        problems.append(pr)
    C, y, W, n_cand = pad_batch(problems, P, R)
    chains = _get_jitted()(
        jnp.asarray(C), jnp.asarray(y), jnp.asarray(W), jnp.asarray(n_cand),
        read_support=3, lookup=jnp.asarray(thr.lookup), scale=thr.scale,
    )
    assert chains.shape == (len(problems), P + 2)
    got = collect_batch_device(chains, list(range(len(problems))),
                               [None] * len(problems))
    want = [solve_host(pr, thr) for pr in problems]
    assert got == want
    assert any(want), "no problem segmented; the comparison is vacuous"


def test_kernel_dots_are_highest_precision():
    """Every contraction of the device DP asks for HIGHEST precision: the
    GPU's default f32 dot may run in TF32, which rounds integer weights
    above 2,048."""
    import jax

    from freddie_jax.ops.segdp import _solve_batch_jax

    thr = ScaledThresholds(0.9)
    B, P, R = 2, 8, 16
    args = (
        np.zeros((B, P, R), np.int32), np.zeros((B, P), np.int32),
        np.ones((B, R), np.float32), np.full((B,), P, np.int32),
    )
    text = jax.jit(
        lambda C, y, W, n, lookup: _solve_batch_jax(C, y, W, n, 3, lookup,
                                                    thr.scale)
    ).lower(*args, np.asarray(thr.lookup)).as_text()
    dots = [line for line in text.splitlines() if "dot_general" in line]
    assert dots
    assert all("precision = [HIGHEST, HIGHEST]" in line for line in dots), dots


@pytest.mark.gpu
def test_kernel_on_gpu_matches_host(gpu_device):
    """On the card: the dispatch path at the P=64 bucket with wide
    weights is bit-identical to the host oracle."""
    import jax

    rng = np.random.default_rng(64)
    thr = ScaledThresholds(0.9)
    problems = []
    for _ in range(32):
        pr = random_problem(rng, 64, 512, span=2560)
        pr.W = wide_weights(rng, 512)
        problems.append(pr)
    with jax.default_device(gpu_device):
        got = solve_batch_device(problems, thr, pad_p_to=64, pad_r_to=512)
    assert got == [solve_host(pr, thr) for pr in problems]
