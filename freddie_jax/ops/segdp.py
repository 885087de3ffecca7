"""The segmentation breakpoint DP -- hot kernel #1.

Replaces the reference's memoized triple-index recursion
(py/freddie_segment.py:475-568) with a closed-form wavefront DP that is
batchable across thousands of problems on the accelerator.

Derivation. The reference maximizes, over chains of breakpoints
start < j0 < k0 < k1 < ... < end, the score

    sum over consecutive segments of  inside(a, b)
  + sum over interior breakpoints of  outside(a, b, c)

where for read-rep coverage ratios between candidates a<b (from the
cumulative coverage matrix C):

    yea(a,b,r):  ratio > high-threshold(len)    [covered]
    nay(a,b,r):  ratio < 1 - high-threshold     [absent]
    inside(a,b)   = - sum_r W_r * ambiguous(a,b,r)
    outside(a,b,c)= sum_r W_r * (yea(a,b,r)&nay(b,c,r) | nay&yea)
                    gated to -inf when below min_read_support_outside
    segments shorter than 5 bp are forbidden.

The reference's recursion D(i,j,k) depends on i only through
inside(i,j)+outside(i,j,k), so with

    H[j,k] = best score of the suffix starting with segment (j,k)
    H[j,end] = inside(j,end)
    H[j,k]   = max_{k_>k} [ -inf if small(j,k) or small(k,k_)
                            else inside(j,k)+outside(j,k,k_)+H[k,k_] ]

the optimum is max over (j,k) of D0[j,k] = inside(0,j)+outside(0,j,k)+H[j,k]
(with smallness masks) against the no-segmentation baseline inside(0,end).
Tie-breaking matches the reference exactly: first (row-major) argmax for the
top-level pair and first argmax over k_ for each backpointer (the
reference's ascending scans with strict improvement).

All threshold decisions use scaled integers (ops.thresholds), so the host
oracle (numpy) and the batched device kernel are bit-identical. Scores are
small integers carried in f32 (exact below 2^24).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from .thresholds import ScaledThresholds

NEG = np.float32(-np.inf)
MIN_SEG_LEN = 5  # py/freddie_segment.py:540


@dataclass
class DPProblem:
    """One segmentation problem: candidates [start..end] of one tint interval.

    C: (P, R) int64 -- cumulative coverage rows at the problem's candidates.
    y: (P,) int64   -- candidate positions (y-space) for lengths/min-seg rules.
    W: (R,) int64   -- read-rep weights (multiplicities).
    """

    C: np.ndarray
    y: np.ndarray
    W: np.ndarray
    read_support: int
    # Optional (K, 3) int32 [ys, ye, rep]: the read-rep intervals
    # overlapping this problem's candidate range. When every problem in
    # a dispatch chunk carries them (and the exactness gates pass), the
    # device builds C itself from these lists (ops.coverage.
    # build_coverage_device) instead of receiving the dense (B, P, R)
    # matrix -- identical kernel results, ~10x fewer host->device bytes.
    iv: "np.ndarray | None" = None


def _pair_tensors(C, y, W, thr: ScaledThresholds):
    """inside (P,P) and outside (P,P,P) tensors, f32 with -inf gates."""
    P = len(y)
    scale = thr.scale
    diff = (C[None, :, :] - C[:, None, :]).astype(np.int64)  # [i,j,r]
    seg_len = (y[None, :] - y[:, None] + 1).astype(np.int64)  # [i,j]
    h = thr.high_scaled(np.maximum(seg_len, 0)).astype(np.int64)
    eq = thr.nay_eq_scaled(np.maximum(seg_len, 0)).astype(np.int64)
    yea = scale * diff > (h * seg_len)[:, :, None]
    nay = scale * diff < ((scale - h) * seg_len + eq)[:, :, None]
    Wf = W.astype(np.float32)
    yeaW = yea.astype(np.float32) * Wf[None, None, :]
    nayW = nay.astype(np.float32) * Wf[None, None, :]
    w_sum = np.float32(Wf.sum())
    inside = -(w_sum - yeaW.sum(axis=2) - nayW.sum(axis=2))  # (P,P)
    outside = np.einsum("ijr,jkr->ijk", yeaW, nay.astype(np.float32)) + np.einsum(
        "ijr,jkr->ijk", nayW, yea.astype(np.float32)
    )
    return inside.astype(np.float32), outside.astype(np.float32), seg_len


def solve_host(problem: DPProblem, thr: ScaledThresholds) -> list[int]:
    """Solve one problem on the host; returns chosen breakpoints (local
    indices in (0, P-1), exclusive of the fixed endpoints)."""
    P = len(problem.y)
    if P <= 2:
        return []
    inside, outside, seg_len = _pair_tensors(problem.C, problem.y, problem.W, thr)
    outside = np.where(outside < problem.read_support, NEG, outside)
    small = (problem.y[None, :] - problem.y[:, None]) < MIN_SEG_LEN  # [a,b] a<b

    end = P - 1
    H = np.full((P, P), NEG, dtype=np.float32)
    K = np.full((P, P), -1, dtype=np.int64)
    H[:end, end] = inside[:end, end]
    for j in range(end - 2, -1, -1):
        # candidates k in (j, end), k_ in (k, end]
        for k in range(j + 1, end):
            if small[j, k]:
                continue
            vals = outside[j, k, k + 1 : end + 1] + H[k, k + 1 : end + 1]
            vals = np.where(small[k, k + 1 : end + 1], NEG, vals)
            best = int(np.argmax(vals))
            if vals[best] == NEG:
                continue
            H[j, k] = inside[j, k] + vals[best]
            K[j, k] = k + 1 + best

    # Top-level selection (first row-major argmax, strict vs no-segmentation).
    D0 = np.full((P, P), NEG, dtype=np.float32)
    for j in range(1, end):
        if small[0, j]:
            continue
        row = inside[0, j] + outside[0, j, j + 1 : end + 1] + H[j, j + 1 : end + 1]
        row = np.where(small[j, j + 1 : end + 1], NEG, row)
        D0[j, j + 1 : end + 1] = row
    baseline = inside[0, end]
    flat = int(np.argmax(D0))
    best_j, best_k = divmod(flat, P)
    if not (D0[best_j, best_k] > baseline):
        return []
    out = [best_j, best_k]
    j, k = best_j, best_k
    while K[j, k] >= 0:
        k_ = int(K[j, k])
        out.append(k_)
        j, k = k, k_
    return out


# ---------------------------------------------------------------------------
# Batched device kernel (XLA; jit-compiled once per padded bucket shape).
# ---------------------------------------------------------------------------


def _solve_batch_jax(C, y, W, n_cand, read_support, lookup, scale):
    """Batched DP over padded problems.

    C: (B, P, R) int32    cumulative coverage (padded reps have W=0)
    y: (B, P) int32       candidate positions (padding: y[n-1] replicated)
    W: (B, R) f32         rep weights
    n_cand: (B,) int32    valid candidate count per problem
    lookup: (L+1,) int32  packed threshold table: h_scaled*2 + eq_nay bit
                          (last entry = rate); see ops/thresholds.py
    Returns (K, best_j, best_k): backpointers (B,P,P) i32 and the top pair
    per problem (-1 when no segmentation wins).
    """
    import jax
    import jax.numpy as jnp

    B, P, R = C.shape
    L = lookup.shape[0] - 1
    neg = jnp.float32(-jnp.inf)

    # --- pair-tensor precompute, scanned over the middle index to keep the
    # live intermediates at (B,P,R) instead of (B,P,P,R); the per-step
    # contraction is a batched (P,R)x(R,P) matmul.
    #
    #   yea(a,b,r) = scale*(C[b]-C[a]) >  h(len)*len        [covered]
    #   nay(a,b,r) = scale*(C[b]-C[a]) < (scale-h)*len + eq  [absent]
    #   inside(a,b)     = -sum_r W_r * ~(yea|nay)
    #   outside(a,b,c)  = sum_r W_r * (yea(a,b)nay(b,c) | nay(a,b)yea(b,c))
    def pair_cols(mid):
        """yea/nay slices with the given index as one side: returns
        (yea_to, nay_to, yea_from, nay_from), each (B,P,R):
        *_to[p] = *(p, mid), *_from[p] = *(mid, p)."""
        C_mid = jax.lax.dynamic_index_in_dim(C, mid, axis=1)  # (B,1,R)
        y_mid = jax.lax.dynamic_index_in_dim(y, mid, axis=1)  # (B,1)
        d_to = C_mid - C  # (B,P,R): C[mid]-C[p]
        len_to = y_mid - y + 1  # (B,P)
        hp_to = lookup[jnp.minimum(jnp.maximum(len_to, 0), L)]
        h_to, eq_to = hp_to >> 1, hp_to & 1  # packed: h_scaled*2 + eq_nay
        yea_to = scale * d_to > (h_to * len_to)[..., None]
        nay_to = scale * d_to < ((scale - h_to) * len_to + eq_to)[..., None]
        d_from = -d_to
        len_from = 2 - len_to  # y[p]-y[mid]+1
        hp_from = lookup[jnp.minimum(jnp.maximum(len_from, 0), L)]
        h_from, eq_from = hp_from >> 1, hp_from & 1
        yea_from = scale * d_from > (h_from * len_from)[..., None]
        nay_from = scale * d_from < ((scale - h_from) * len_from + eq_from)[..., None]
        return yea_to, nay_to, yea_from, nay_from

    w_sum = jnp.sum(W, axis=1)[:, None]  # (B,1)

    def precompute_step(_, k):
        yea_to, nay_to, yea_from, nay_from = pair_cols(k)
        # inside column: inside(i, k) for all i.
        in_col = -(
            w_sum
            - jnp.sum(yea_to.astype(jnp.float32) * W[:, None, :], axis=2)
            - jnp.sum(nay_to.astype(jnp.float32) * W[:, None, :], axis=2)
        )  # (B,P)
        # outside slice over the middle index k: out_k[j, k_] =
        #   sum_r yeaW(j,k,r)*nay(k,k_,r) + nayW(j,k,r)*yea(k,k_,r)
        yeaW_to = yea_to.astype(jnp.float32) * W[:, None, :]
        nayW_to = nay_to.astype(jnp.float32) * W[:, None, :]
        # HIGHEST precision: the GPU's default f32 dot may run in TF32,
        # whose 10-bit mantissa keeps integers exact only up to 2,048, and
        # rep weights reach 16,383. At HIGHEST the products and their f32
        # sums are exact (every score stays below 2^24), so the device
        # and the host oracle agree bit for bit.
        out_k = jnp.einsum(
            "bjr,bkr->bjk", yeaW_to, nay_from.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        ) + jnp.einsum(
            "bjr,bkr->bjk", nayW_to, yea_from.astype(jnp.float32),
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        return None, (in_col, out_k)

    ks = jnp.arange(P, dtype=jnp.int32)
    with jax.named_scope("segdp_pair_precompute"):
        _, (in_cols, out_mid) = jax.lax.scan(precompute_step, None, ks)
    # in_cols: (P_k, B, P_i) -> inside (B, i, j)
    inside = jnp.moveaxis(in_cols, 0, 2)
    # out_mid: (P_k, B, P_j, P_k_) -> outside (B, j, k, k_)
    outside = jnp.moveaxis(out_mid, 0, 2)
    outside = jnp.where(outside < read_support, neg, outside)

    end = (n_cand - 1)[:, None]  # (B,1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)  # (B,P)
    small = (y[:, None, :] - y[:, :, None]) < MIN_SEG_LEN  # (B,a,b)

    # H init: column `end` holds inside(j, end) for j < end.
    is_end_col = idx[:, None, :] == end[:, :, None]  # (B,j,k): k == end
    j_lt_end = idx[:, :, None] < end[:, :, None]
    inside_j_end = jnp.take_along_axis(
        inside, jnp.broadcast_to(end[:, :, None], (B, P, 1)), axis=2
    )  # (B,j,1) = inside[b,j,end]
    H0 = jnp.where(is_end_col & j_lt_end, inside_j_end, neg)  # (B,P,P)

    kk = idx  # alias for clarity: candidate index along a P axis

    def step(H, j):
        # Row j of H: for k in (j, end), H[j,k] = inside[j,k] + max_k_ (...)
        out_j = jax.lax.dynamic_index_in_dim(outside, j, axis=1, keepdims=False)
        # (B,k,k_) values
        in_j = jax.lax.dynamic_index_in_dim(inside, j, axis=1, keepdims=False)
        small_j = jax.lax.dynamic_index_in_dim(small, j, axis=1, keepdims=False)
        vals = out_j + H  # (B,k,k_): outside[j,k,k_] + H[k,k_]
        kmask = (
            (kk[:, :, None] < kk[:, None, :])  # k_ > k
            & (kk[:, None, :] <= end[:, :, None])  # k_ <= end
            & ~small[..., :, :]  # small(k,k_)
        )
        vals = jnp.where(kmask, vals, neg)
        row_max = jnp.max(vals, axis=2)  # (B,k)
        row_arg = jnp.argmax(vals, axis=2).astype(jnp.int32)
        valid_k = (kk > j) & (kk < end) & ~small_j & (row_max > neg)
        row_H = jnp.where(valid_k, in_j + row_max, neg)
        # Preserve the end column (and -inf elsewhere) from H0-style init.
        keep = kk == end
        in_j_end = jnp.take_along_axis(in_j, end, axis=1)  # (B,1)
        row_H = jnp.where(keep & (j < end), in_j_end, row_H)
        row_K = jnp.where(valid_k, row_arg, -1)
        H = jax.lax.dynamic_update_index_in_dim(H, row_H, j, axis=1)
        return H, (row_H, row_K)

    js = jnp.arange(P - 2, -1, -1, dtype=jnp.int32)
    with jax.named_scope("segdp_wavefront"):
        H_final, (rows_H, rows_K) = jax.lax.scan(step, H0, js)
    # Scatter emitted rows back into (B,P,P) order.
    K = jnp.full((B, P, P), -1, dtype=jnp.int32)
    K = K.at[:, js, :].set(jnp.moveaxis(rows_K, 0, 1)[:, :, :])

    # Top level: D0[j,k] = inside[0,j] + outside[0,j,k] + H[j,k], masks.
    in0 = inside[:, 0, :]  # (B,j)
    out0 = outside[:, 0, :, :]  # (B,j,k)
    small0 = small[:, 0, :]  # (B,j)
    jmask = (
        (kk[:, :, None] > 0)
        & (kk[:, :, None] < end[:, :, None])  # 0 < j < end
        & (kk[:, None, :] > kk[:, :, None])  # k > j
        & (kk[:, None, :] <= end[:, :, None])  # k <= end
        & ~small0[:, :, None]  # small(0,j)
        & ~small[..., :, :]  # small(j,k)
    )
    D0 = jnp.where(jmask, in0[:, :, None] + out0 + H_final, neg)
    baseline = jnp.take_along_axis(in0, end, axis=1)[:, 0]  # inside[0,end]
    flat = jnp.argmax(D0.reshape(B, P * P), axis=1)
    best = jnp.max(D0.reshape(B, P * P), axis=1)
    ok = best > baseline
    best_j = jnp.where(ok, flat // P, -1).astype(jnp.int32)
    best_k = jnp.where(ok, flat % P, -1).astype(jnp.int32)
    return K, best_j, best_k


def _walk_chains(K, best_j, best_k):
    """Walk every problem's backpointer chain ON DEVICE.

    The host only needs the chain (<= P breakpoints per problem), but K is
    (B, P, P) -- reading it back moves P**2/chain-length times more bytes
    than needed (33 MB per 2048x64 chunk). This jittable walk reproduces collect's loop exactly -- out = [j, k], then
    k_ = K[b, j, k] while >= 0 -- and returns (B, P+2) int32 chains,
    -1-terminated (all -1 when no segmentation won)."""
    import jax
    import jax.numpy as jnp

    B, P, _ = K.shape
    Kf = K.reshape(B, P * P)
    alive0 = best_j >= 0

    def step(carry, _):
        j, k, alive = carry
        idx = jnp.clip(j * P + k, 0, P * P - 1)
        nxt = jnp.take_along_axis(Kf, idx[:, None], axis=1)[:, 0]
        alive = alive & (nxt >= 0)
        out = jnp.where(alive, nxt, -1)
        j = jnp.where(alive, k, j)
        k = jnp.where(alive, nxt, k)
        return (j, k, alive), out

    (_, _, _), rest = jax.lax.scan(step, (best_j, best_k, alive0), None, length=P)
    return jnp.concatenate(
        [best_j[:, None], jnp.where(alive0, best_k, -1)[:, None],
         jnp.transpose(rest)],
        axis=1,
    ).astype(jnp.int32)


_jitted_cache: dict = {}


def _get_jitted():
    import jax

    if "fn" not in _jitted_cache:

        def xla_chains(C, y, W, n_cand, read_support, lookup, scale):
            K, bj, bk = _solve_batch_jax(
                C.astype("int32"), y, W, n_cand, read_support, lookup, scale
            )
            return _walk_chains(K, bj, bk)

        _jitted_cache["fn"] = jax.jit(
            xla_chains, static_argnames=("read_support", "scale")
        )
    return _jitted_cache["fn"]


# Bucket edges of bucket_shape: candidates (P) and read-reps (R).
P_EDGES = (16, 32, 64)
R_EDGES = (128, 256, 384, 512, 768, 1024, 1536)


def bucket_shape(n_cand: int, n_reps: int) -> tuple[int, int]:
    """The padded (P, R) bucket a problem lands in. ONE definition shared
    by the batch helper and the streaming stage driver, so the compiled
    kernel-shape set (which dryrun_multichip and chip_smoke.py rehearse)
    cannot silently diverge between them.
    Coarse edges keep the shape count small; past the last edge, round
    up by the step."""

    def edge(x, edges, step):
        for e in edges:
            if x <= e:
                return e
        return ((x + step - 1) // step) * step

    # R edges are 128-multiples spaced so the rep-padding waste stays
    # under ~50%: both the kernel's elementwise passes and the
    # host->device transfer scale with R, so a tint with 270 reps in a
    # 384 bucket costs 25% less than in 512 (a corpus only ever compiles
    # the shapes it actually hits, and the persistent cache makes each a
    # one-time cost).
    return edge(n_cand, P_EDGES, 32), edge(n_reps, R_EDGES, 512)


def suggested_batch_size(P: int, R: int, budget_bytes: int = 4 << 30) -> int:
    """Batch size keeping the (B,P,P,R) intermediates within budget."""
    per_problem = P * P * R * 4 * 6 + P * P * P * 4
    return max(1, min(4096, budget_bytes // max(per_problem, 1)))


def dispatch_batch_device(
    problems: list[DPProblem],
    thr: ScaledThresholds,
    pad_p_to: int = 8,
    pad_r_to: int = 128,
    pad_b_to: int = 0,
    dev_cov: bool | None = None,
):
    """Launch a padded batch on the device WITHOUT waiting for it.

    Returns (handles, work, results): `handles` is the (B, P+2) int32
    device array of -1-terminated breakpoint chains (walked ON device by
    _walk_chains; None when every problem was solved inline on the
    host), `work` the indices launched, `results` the partially-filled
    output list. collect_batch_device() finishes the job. Splitting
    dispatch from collection lets the stage keep several launches in
    flight while the host prepares the next chunk (the readback is the
    only synchronization point).
    """
    import jax
    import jax.numpy as jnp

    if not problems:
        return None, [], []
    results: list[list[int] | None] = [None] * len(problems)
    work = []
    for i, pr in enumerate(problems):
        if len(pr.y) <= 2:
            results[i] = []
        else:
            work.append(i)
    if not work:
        return None, [], results

    def rnd(x, m):
        return ((x + m - 1) // m) * m

    P = rnd(max(len(problems[i].y) for i in work), pad_p_to)
    R = rnd(max(problems[i].C.shape[1] for i in work), pad_r_to)
    # Pad the batch dim to a power of two: B is part of the compiled
    # kernel shape, so without padding every dataset's batch counts force
    # fresh compilations; with it the shape set is stable across datasets
    # and the persistent cache makes compiles one-time. Padding rows replicate problem 0 (their
    # outputs are discarded); a power of two is also always a multiple of
    # the (power-of-two) local device count for the sharded path.
    B = len(work)
    B_pad = 8
    while B_pad < B:
        B_pad <<= 1
    # pad_b_to lets the streaming driver pad a final partial chunk up to
    # the bucket's standard chunk size, so it reuses the SAME compiled
    # executable instead of minting a fresh shape.
    B_pad = max(B_pad, pad_b_to)
    y = np.zeros((B_pad, P), dtype=np.int32)
    W = np.zeros((B_pad, R), dtype=np.float32)
    n_cand = np.zeros((B_pad,), dtype=np.int32)
    rs = {problems[i].read_support for i in work}
    assert len(rs) == 1, "mixed read_support in one batch"
    for b, i in enumerate(work):
        pr = problems[i]
        p = len(pr.y)
        y[b, :p] = pr.y
        y[b, p:] = pr.y[-1]
        W[b, : len(pr.W)] = pr.W
        n_cand[b] = p
    if B_pad > B:
        y[B:] = y[0]
        W[B:] = W[0]
        n_cand[B:] = n_cand[0]

    # Device-side coverage build: when every problem carries its interval
    # list, ship the (B, I, 3) lists and let the device build C itself
    # (ops.coverage.build_coverage_device) -- identical kernel results
    # (C enters only through differences; docstring there), ~10x fewer
    # host->device bytes. Content gates only: interval-count cap (shape
    # sanity) and the same int32 threshold-product bound (device-built C
    # values are bounded by the candidate range, i.e. by max(y)).
    # dev_cov=None (direct callers) defaults on; the stage driver passes
    # False for small corpora where the extra build launch costs more
    # than the saved bytes (the route is value-neutral either way).
    # FREDDIE_DEVICE_COVERAGE=0/1 overrides both.
    env_cov = os.environ.get("FREDDIE_DEVICE_COVERAGE")
    want_cov = (
        env_cov != "0"
        if env_cov is not None
        else (True if dev_cov is None else dev_cov)
    )
    use_dev_cov = (
        want_cov
        # the sharded branch pads B by np.concatenate for non-power-of-2
        # device counts; B_pad (a power of two) already covers the
        # power-of-2 meshes, so only the unusual counts fall back
        and (-B_pad) % jax.local_device_count() == 0
        and all(problems[i].iv is not None for i in work)
        and thr.scale * (int(y.max(initial=0)) + 1) < 2**31
    )
    if use_dev_cov:
        I_max = max(len(problems[i].iv) for i in work)
        if I_max > 4096:
            use_dev_cov = False
    if use_dev_cov:
        # Coarse I buckets: every distinct (B, I, P) mints a build
        # executable, and padding rows cost only cheap device compute + a
        # few KB of transfer -- so three buckets cover everything.
        I_pad = 512 if I_max <= 512 else (2048 if I_max <= 2048 else 4096)
        iv = np.zeros((B_pad, I_pad, 3), dtype=np.int32)
        iv[:, :, 1] = -1  # padding: empty interval
        iv[:, :, 2] = R  # padding rep -> dropped row of the segment sum
        for b, i in enumerate(work):
            pv = problems[i].iv
            iv[b, : len(pv)] = pv
        if B_pad > B:
            iv[B:] = iv[0]
        from .coverage import build_coverage_device

        C = build_coverage_device(iv, y, R)  # (B, P, R) int32 ON DEVICE
    else:
        C = np.zeros((B_pad, P, R), dtype=np.int32)
        for b, i in enumerate(work):
            pr = problems[i]
            p, r = pr.C.shape
            C[b, :p, :r] = pr.C
            C[b, p:, :r] = pr.C[-1]  # replicate last row; padded y too
        if B_pad > B:
            C[B:] = C[0]

        # The device kernel compares thresholds in int32; the host oracle
        # uses int64. With the
        # default threshold_rate the scale is small (10), but a rate
        # needing scale >= 1000 combined with ~1e6+ coverages/positions
        # could silently overflow int32 -- in that regime solve each
        # problem on the host (results are bit-identical either way).
        max_operand = max(int(C.max(initial=0)), int(y.max(initial=0)) + 1)
        if thr.scale * max_operand >= 2**31:
            for i in work:
                results[i] = solve_host(problems[i], thr)
            return None, [], results
        # C dominates the host->device bytes; ship it as int16 whenever
        # every coverage fits (the common case) and widen on device --
        # halves the transfer, identical values.
        if int(C.max(initial=0)) < 2**15:
            C = C.astype(np.int16)

    n_local = jax.local_device_count()
    if n_local > 1:
        # Multi-device host: shard the batch over a 1-D loci mesh so one
        # process drives every attached device (bit-identical to the
        # single-device launch). B_pad (a power of two) already covers any
        # power-of-two device count; pad further only for unusual mesh
        # sizes.
        from ..parallel.mesh import loci_mesh, solve_batch_sharded

        mesh = loci_mesh(local=True)
        pad_b = (-B_pad) % n_local
        if pad_b:
            C = np.concatenate([C, np.repeat(C[-1:], pad_b, axis=0)])
            y = np.concatenate([y, np.repeat(y[-1:], pad_b, axis=0)])
            W = np.concatenate([W, np.repeat(W[-1:], pad_b, axis=0)])
            n_cand = np.concatenate([n_cand, np.repeat(n_cand[-1:], pad_b)])
        chains = solve_batch_sharded(
            C, y, W, n_cand, next(iter(rs)), thr.lookup, thr.scale, mesh,
            return_chains=True,
        )
    else:
        fn = _get_jitted()
        chains = fn(
            jnp.asarray(C),
            jnp.asarray(y),
            jnp.asarray(W),
            jnp.asarray(n_cand),
            read_support=next(iter(rs)),
            lookup=jnp.asarray(thr.lookup),
            scale=thr.scale,
        )
    return chains, work, results


def collect_batch_device(handles, work, results) -> list[list[int]]:
    """Read back a dispatch_batch_device launch. The chains were walked on
    device (_walk_chains); the np.asarray readback is the synchronization
    point and moves only (B, P+2) int32."""
    if handles is not None:
        chains = np.asarray(handles)
        for b, i in enumerate(work):
            row = chains[b]
            if row[0] < 0:
                results[i] = []
                continue
            stop = np.flatnonzero(row < 0)
            results[i] = row[: stop[0] if len(stop) else len(row)].tolist()
    return [r for r in results]  # type: ignore


def solve_batch_device(
    problems: list[DPProblem],
    thr: ScaledThresholds,
    pad_p_to: int = 8,
    pad_r_to: int = 128,
) -> list[list[int]]:
    """Solve a batch of problems on the device (or CPU backend for tests).

    Problems are padded to a common (P, R); identical results to
    solve_host, bit for bit. Returns per-problem local breakpoint chains.
    dispatch_batch_device/collect_batch_device are the async halves for
    callers overlapping several launches.
    """
    handles, work, results = dispatch_batch_device(
        problems, thr, pad_p_to=pad_p_to, pad_r_to=pad_r_to,
    )
    return collect_batch_device(handles, work, results)
