"""Cumulative coverage of read representatives over candidate segments.

Dense, vectorized equivalent of the reference's per-interval scatter +
prefix sum (py/freddie_segment.py:188-246): for candidate breakpoint
indices ``cands`` (y-space, sorted, within one tint interval),

    C[c, r] = number of bases of read-rep r lying before candidate c
              (counting each aligned interval inclusively on both ends),

so C[j] - C[i] is the coverage of rep r strictly between candidates i and
j. Shapes are (n_cands + 1, n_reps) like the reference; row 0 is the
coverage before the first candidate.
"""

from __future__ import annotations

import numpy as np


def cumulative_coverage(
    starts: np.ndarray,  # (n_iv,) read-rep interval starts, y-space
    ends: np.ndarray,  # (n_iv,) read-rep interval ends, y-space (inclusive span s..e)
    reps: np.ndarray,  # (n_iv,) read-rep index of each interval
    n_reps: int,
    cands: np.ndarray,  # (P,) sorted candidate y indices
    validate: bool = False,
) -> np.ndarray:
    P = len(cands)
    C = np.zeros((P + 1, n_reps), dtype=np.int64)
    if len(starts) == 0:
        return C
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    reps = np.asarray(reps, dtype=np.int64)
    cands = np.asarray(cands, dtype=np.int64)

    s_idx = np.searchsorted(cands, starts, side="right")
    e_idx = np.searchsorted(cands, ends, side="right")
    same = s_idx == e_idx
    m = ~same

    # Head/tail pieces of intervals spanning >= 2 candidate segments, and
    # whole inclusive lengths of intervals inside one segment. All three
    # scatters go through one bincount over flattened (row, rep) indices
    # (much faster than np.add.at); float64 weights are exact for integer
    # sums below 2^53, far above any real coverage total.
    head = cands[s_idx[m]] - starts[m]
    tail = ends[m] - cands[e_idx[m] - 1] + 1
    if validate:
        assert np.all(head > 0) and np.all(tail > 0)
    size = (P + 1) * n_reps
    idx_all = np.concatenate(
        [s_idx[same] * n_reps + reps[same],
         s_idx[m] * n_reps + reps[m],
         e_idx[m] * n_reps + reps[m]]
    )
    w_all = np.concatenate([ends[same] - starts[same] + 1, head, tail])
    C += np.bincount(idx_all, weights=w_all, minlength=size).astype(
        np.int64
    ).reshape(P + 1, n_reps)

    # Full middle segments: candidate gaps times the span count, built with a
    # difference array over rows (+1 at the first full row, -1 past the last).
    n_m = int(m.sum())
    span_idx = np.concatenate(
        [(s_idx[m] + 1) * n_reps + reps[m], e_idx[m] * n_reps + reps[m]]
    )
    span_w = np.concatenate([np.ones(n_m), -np.ones(n_m)])
    span = np.bincount(span_idx, weights=span_w, minlength=size).astype(
        np.int64
    ).reshape(P + 1, n_reps)
    span = np.cumsum(span, axis=0)
    gaps = np.zeros(P + 1, dtype=np.int64)
    gaps[1:P] = cands[1:] - cands[:-1]
    C += span * gaps[:, None]

    if validate:
        total = int((ends - starts + 1).sum())
        assert C.sum() == total, (C.sum(), total)
    np.cumsum(C, axis=0, out=C)
    return C


# ------------------------------------------------- device-side builder
#
# The segmentation kernels consume C only through DIFFERENCES
# C[k]-C[p] (the pair statistics), and C has the closed form
#
#     C[c, r] = sum over intervals i of rep r of
#               max(0, min(ye_i, cands[c] - 1) - ys_i + 1)
#
# (each row-scatter + prefix-sum case of cumulative_coverage reduces to
# this clamp; intervals entirely below the candidate range add the same
# constant to every row and intervals entirely above add zero, so a
# problem's C can be built from just the intervals OVERLAPPING its
# candidate range, with all differences exactly equal to the host's).
# Building C on device therefore replaces the dense (B, P, R) host
# transfer with the (B, I, 3) interval lists -- the host->device bytes of
# the segment stage's device path. Integer scatter-adds keep it exact.

_build_cache: dict = {}


def build_coverage_device(iv, y, n_reps: int):
    """C (B, P, R) int32 ON DEVICE from interval lists.

    iv: (B, I, 3) int32 [ys, ye, rep] with padding rows rep == n_reps;
    y: (B, P) int32 candidate positions. Exact integer arithmetic
    (scatter-add); value-compatible with cumulative_coverage up to a
    per-(problem, rep) additive constant that cancels in every kernel.
    """
    import jax

    key = (iv.shape, y.shape, n_reps)
    fn = _build_cache.get(key)
    if fn is None:

        def build(iv, y):
            import jax.numpy as jnp

            ys = iv[..., 0]  # (B, I)
            ye = iv[..., 1]
            rep = iv[..., 2]
            ov = jnp.maximum(
                0,
                jnp.minimum(ye[:, :, None], y[:, None, :] - 1)
                - ys[:, :, None]
                + 1,
            )  # (B, I, P) int32
            seg = jax.vmap(
                lambda o, r: jax.ops.segment_sum(
                    o, r, num_segments=n_reps + 1
                )
            )(ov, rep)  # (B, n_reps+1, P); padding rows land in row n_reps
            return jnp.swapaxes(seg[:, :n_reps, :], 1, 2)  # (B, P, R)

        fn = jax.jit(build)
        _build_cache[key] = fn
    return fn(iv, y)
