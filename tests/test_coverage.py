"""Cumulative-coverage matrix vs a naive per-base oracle."""

import numpy as np

from freddie_jax.ops.coverage import cumulative_coverage


def naive(starts, ends, reps, n_reps, cands):
    """Direct per-interval implementation of py/freddie_segment.py:188-246."""
    import bisect

    P = len(cands)
    C = np.zeros((P + 1, n_reps), dtype=np.int64)
    for s, e, r in zip(starts, ends, reps):
        ci_s = bisect.bisect_right(list(cands), s)
        ci_e = bisect.bisect_right(list(cands), e, lo=ci_s)
        if ci_s == ci_e:
            C[ci_s][r] += e - s + 1
            continue
        C[ci_s][r] += cands[ci_s] - s
        C[ci_e][r] += e - cands[ci_e - 1] + 1
        for ci in range(ci_s + 1, ci_e):
            C[ci][r] += cands[ci] - cands[ci - 1]
    for i in range(1, P + 1):
        C[i] += C[i - 1]
    return C


def test_matches_naive_random():
    rng = np.random.default_rng(0)
    for _ in range(20):
        P = int(rng.integers(2, 25))
        span = 3000
        cands = np.sort(rng.choice(np.arange(span), size=P, replace=False))
        # ensure candidate 0 at position 0 like the real pipeline
        cands[0] = 0
        cands = np.unique(cands)
        n_reps = int(rng.integers(1, 10))
        n_iv = int(rng.integers(0, 40))
        starts, ends, reps = [], [], []
        for _ in range(n_iv):
            s = int(rng.integers(0, span - 2))
            e = int(rng.integers(s, span - 1))
            starts.append(s)
            ends.append(e)
            reps.append(int(rng.integers(0, n_reps)))
        got = cumulative_coverage(
            np.array(starts, dtype=np.int64),
            np.array(ends, dtype=np.int64),
            np.array(reps, dtype=np.int64),
            n_reps,
            np.asarray(cands, dtype=np.int64),
            validate=False,
        )
        want = naive(starts, ends, reps, n_reps, list(cands))
        assert np.array_equal(got, want)
