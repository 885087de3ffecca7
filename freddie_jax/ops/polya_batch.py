"""Batched polyA-run scoring as associative/segmented scans (kernel
target 4 of SURVEY.md section 3.2).

The reference scores each soft-clip window with a Kadane-style recurrence
s_i = max(0, s_{i-1} + m_i) (match +1 / mismatch -2), splits the score
vector into maximal positive runs and yields per run
(first, length-to-best-score, purity), keeping runs with length >= 20 and
purity >= 0.85 and choosing the best by purity
(py/freddie_segment.py:352-367 + 402-449).

Here the same computation runs for a whole batch of windows at once:

- the Kadane recurrence is an associative scan over affine-max maps
  f(x) = max(c, x + a), which compose as
  (c2, a2) . (c1, a1) = (max(c2, c1 + a2), a1 + a2);
- run decomposition and per-run best-score/first-index are segmented
  scans keyed on run starts;
- purity ordering uses a float32 ratio, which is order-exact for window
  lengths <= 2048 (distinct rationals cnt/len with denominators <= L
  differ by >= 1/L^2, far above the f32 division error), and the gates
  use exact integer cross-multiplication.

Results are identical to the host implementation (ops.polya);
tests/test_polya_batch.py checks every window against it.
"""

from __future__ import annotations

import os

import numpy as np

# Device-path cap on window length; longer windows use the host scorer
# (byte-identical results either way -- the batch path is equivalence-
# tested against it). Two forces bound this: the f32 purity-ordering
# proof below needs L <= 2048, and the compiled associative scans grow
# steeply with L. Long soft-clips are rare, so the host Kadane absorbs
# them cheaply.
MAX_WINDOW = 256


def _scan_batch_packed(packed: "jnp.ndarray", lens: "jnp.ndarray"):
    """Packed-transfer wrapper: packed is (B, L//8) uint8 (np.packbits of
    the match mask, big bit-order), lens (B,) int32 window lengths. The
    transfer is 16x smaller than the unpacked masks; the unpack is a few
    element-wise ops fused into the scan."""
    import jax.numpy as jnp

    B, L8 = packed.shape
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)  # big bitorder: MSB first
    bits = (packed[:, :, None] >> shifts[None, None, :]) & jnp.uint8(1)
    match = bits.reshape(B, L8 * 8) != 0
    valid = jnp.arange(L8 * 8, dtype=jnp.int32)[None, :] < lens[:, None]
    return _scan_batch(match, valid)


def _scan_batch(match: "jnp.ndarray", valid: "jnp.ndarray"):
    """For (B, L) bool match/valid masks, return per-window best candidate
    (found, first, length, count) under the reference's rules."""
    import jax
    import jax.numpy as jnp

    B, L = match.shape
    m = jnp.where(valid, jnp.where(match, 1, -2), -(10**6)).astype(jnp.int32)

    # Kadane scores via affine-max composition scan.
    def combine(f1, f2):
        c1, a1 = f1
        c2, a2 = f2
        return jnp.maximum(c2, c1 + a2), a1 + a2

    # Each step is f_i(x) = max(0, x + m_i) == (c=0, a=m_i); the scan
    # composes prefixes and s_i = F_i(0) = max(C_i, A_i). The s_0 special
    # case (match ? 1 : 0) equals max(0, m_0).
    cs, as_ = jax.lax.associative_scan(
        combine, (jnp.zeros_like(m), m), axis=1
    )
    s = jnp.maximum(cs, as_)

    pos = s > 0
    prev_pos = jnp.pad(pos[:, :-1], ((0, 0), (1, 0)), constant_values=False)
    start = pos & ~prev_pos
    next_pos = jnp.pad(pos[:, 1:], ((0, 0), (0, 1)), constant_values=False)
    end = pos & ~next_pos

    idx = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32)[None, :], (B, L))

    # Segmented scans: flags reset at run starts.
    def seg_combine(x1, x2):
        f1, v1 = x1
        f2, v2 = x2
        return f1 | f2, jnp.where(f2, v2, jnp.maximum(v1, v2))

    # best (score, index) per prefix-in-run; key = s*(L+1) + idx gives
    # highest score, ties -> highest index (the reference's max(zip(S,i))).
    key = s * jnp.int32(L + 1) + idx
    _, seg_best = jax.lax.associative_scan(
        seg_combine, (start, jnp.where(pos, key, -1)), axis=1
    )
    # first index per run: carry the start's index forward.
    def seg_first(x1, x2):
        f1, v1 = x1
        f2, v2 = x2
        return f1 | f2, jnp.where(f2, v2, v1)

    _, seg_f = jax.lax.associative_scan(
        seg_first, (start, jnp.where(start, idx, 0)), axis=1
    )

    # Prefix counts of matches for purity numerators.
    cnt_prefix = jnp.cumsum(match.astype(jnp.int32) & valid.astype(jnp.int32), axis=1)
    cnt_before = jnp.pad(cnt_prefix[:, :-1], ((0, 0), (1, 0)))

    best_idx = seg_best % jnp.int32(L + 1)
    first = seg_f
    length = best_idx + 1 - first
    # count of matches in [first, first+length) = [first, best_idx]
    cnt = jnp.take_along_axis(cnt_prefix, best_idx, axis=1) - jnp.take_along_axis(
        cnt_before, first, axis=1
    )

    # Candidates live at run ends; gates: length >= 20, purity >= 0.85
    # (exact: 20*cnt >= 17*length).
    cand = end & (length >= 20) & (20 * cnt >= 17 * length)
    purity = jnp.where(cand, cnt.astype(jnp.float32) / length.astype(jnp.float32), -1.0)
    pmax = jnp.max(purity, axis=1)  # (B,)
    found = pmax > 0
    first_best = jnp.argmax(purity == pmax[:, None], axis=1)  # earliest run
    take = lambda a: jnp.take_along_axis(a, first_best[:, None], axis=1)[:, 0]
    return (
        found,
        jnp.where(found, take(first), 0),
        jnp.where(found, take(length), 0),
        jnp.where(found, take(cnt), 0),
    )


def _scan_np(match: np.ndarray, lens: np.ndarray):
    """Numpy twin of _scan_batch for arbitrary window lengths (also the
    whole-batch path on CPU backends, where it beats dispatching the
    jitted scan): fully vectorized, no Python loop over columns.

    The Kadane recurrence s_i = max(0, s_{i-1} + m_i) has the closed form
    s_i = P_i - min(0, P_0, ..., P_i) with P the prefix sums of m (the
    best suffix sum ending at i, empty suffix allowed), so the score
    matrix is one cumsum + one cummin. Runs (maximal s>0 stretches) are
    reduced with np.maximum.reduceat over the flattened matrix: gaps
    between runs carry key -1 (< every in-run key), so segments from one
    run start to the next are equivalent to exact run extents, and no
    segment straddles rows because a positive score at column 0 is
    always flagged as a run start (prev_pos there is defined False).
    Purity comparisons run in float64, exactly like the per-window host
    scorer (ops.polya.longest_poly_runs + max by purity with the
    earliest-closed run winning ties); returns the same
    (found, first, length, cnt) contract as the device scan."""
    B0, L = match.shape
    valid0 = np.arange(L, dtype=np.int32)[None, :] < lens[:, None]
    best_first = np.zeros(B0, np.int64)
    best_len = np.zeros(B0, np.int64)
    best_cnt = np.zeros(B0, np.int64)

    # Exact pre-filter: a qualifying run needs length >= 20 and
    # 20*cnt >= 17*length => cnt >= 17 matches, so rows with a shorter
    # window or fewer total matches can never produce one. Noisy
    # soft-clip windows are mostly junk, so this removes the bulk of the
    # batch before the multi-pass scan arithmetic.
    active = np.flatnonzero(
        (lens >= 20) & ((match & valid0).sum(axis=1) >= 17)
    )
    if active.size == 0:
        return np.zeros(B0, bool), best_first, best_len, best_cnt
    match = match[active] & valid0[active]
    B = len(active)

    # With padding masked to mismatch, every score step is m_i = 3*match-2
    # (padding scores decay like mismatches: runs can only shrink toward
    # their in-window best, never start or improve past `lens`, so
    # results are unchanged), and the prefix sums come straight from the
    # match-count prefix: P_i = 3*cnt_i - 2*(i+1). |P| <= 2L and
    # key <= L*(L+1), so everything fits int32.
    assert L < 32768
    cnt_prefix = np.cumsum(match, axis=1, dtype=np.int32)
    P = 3 * cnt_prefix - np.arange(2, 2 * L + 2, 2, dtype=np.int32)[None, :]

    prefmin = np.minimum.accumulate(
        np.concatenate([np.zeros((B, 1), np.int32), P], axis=1), axis=1
    )
    s = P - prefmin[:, 1:]

    pos = s > 0
    prev_pos = np.zeros_like(pos)
    prev_pos[:, 1:] = pos[:, :-1]
    start = pos & ~prev_pos
    starts_flat = np.flatnonzero(start.ravel())
    if starts_flat.size == 0:
        return np.zeros(B0, bool), best_first, best_len, best_cnt

    # Per-run best position: key = s*(L+1)+col (max s, ties -> latest col,
    # the reference's max(zip(S, i))); -1 outside runs.
    cols = np.arange(L, dtype=np.int32)[None, :]
    key = np.where(pos, s * np.int32(L + 1) + cols, np.int32(-1)).ravel()
    runbest = np.maximum.reduceat(key, starts_flat)

    run_row = starts_flat // L
    first = starts_flat % L
    best_col = runbest % (L + 1)
    length = best_col + 1 - first
    cnt = cnt_prefix[run_row, best_col] - np.where(
        first > 0, cnt_prefix[run_row, np.maximum(first - 1, 0)], 0
    )
    ok = (length >= 20) & (20 * cnt >= 17 * length)
    purity = np.where(ok, cnt / np.maximum(length, 1), -1.0)

    # Per-row winner: max purity, earliest run on ties (runs are in
    # ascending (row, first) order, so "first run attaining the row max"
    # reproduces the sequential strict-> update).
    grp_starts = np.flatnonzero(np.concatenate([[True], np.diff(run_row) != 0]))
    pmax = np.maximum.reduceat(purity, grp_starts)
    run_idx = np.arange(len(run_row), dtype=np.int64)
    grp_of_run = np.cumsum(np.concatenate([[True], np.diff(run_row) != 0])) - 1
    is_win = purity == pmax[grp_of_run]
    winner = np.minimum.reduceat(
        np.where(is_win, run_idx, len(run_row)), grp_starts
    )
    grp_row = run_row[grp_starts]
    grp_found = pmax > -1.0
    w = winner[grp_found]
    rows_found = active[grp_row[grp_found]]  # back to pre-filter rows
    found = np.zeros(B0, bool)
    found[rows_found] = True
    best_first[rows_found] = first[w]
    best_len[rows_found] = length[w]
    best_cnt[rows_found] = cnt[w]
    return found, best_first, best_len, best_cnt


_jit_cache: dict = {}


def _get_scan():
    """_scan_batch_packed under jit (cached): the whole unpack+scan
    compiles to one launch per padded (B, L) bucket shape."""
    if "fn" not in _jit_cache:
        import jax

        _jit_cache["fn"] = jax.jit(_scan_batch_packed)
    return _jit_cache["fn"]


_L_BUCKETS = (64, MAX_WINDOW)
_MAX_ROWS = 8192  # compiled executable size also grows with rows; chunk


def _pad_rows(b: int) -> int:
    """Round the batch dim to a coarse bucket so the compiled shape set
    stays tiny across calls (each shape is a compile; the scan itself is
    cheap, so padding waste is the right trade). Callers
    chunk at _MAX_ROWS, so the full shape set is {1024, 8192} x
    _L_BUCKETS."""
    for p in (1024, _MAX_ROWS):
        if b <= p:
            return p
    raise AssertionError(f"chunk rows {b} > {_MAX_ROWS}")


def best_poly_batch(windows: list[str], chars: list[str]):
    """For each (window string, target char) pair, the reference's best
    run or None: list of (first, length, count_of_char) tuples.

    Launches are bucketed by padded window length and power-of-two batch
    size to bound the number of compiled shapes. Windows longer than
    MAX_WINDOW fall back to the host scorer.
    """
    import jax.numpy as jnp

    from .polya import _load_ctok

    ctok = _load_ctok()
    if ctok is not None and not hasattr(ctok, "best_run"):
        ctok = None

    def host_score(rows):
        """Host-score the given window indices: the C Kadane scorer when
        built (one call per window, no grid assembly), else the numpy
        twin -- identical results either way (fuzz-pinned)."""
        if ctok is not None:
            for i in rows:
                r = ctok.best_run(windows[i], 0, len(windows[i]), 0, chars[i])
                if r is not None:
                    results[i] = r
            return
        # Sort by window length BEFORE chunking so each chunk's grid pads
        # to a tight per-chunk maximum instead of the global one.
        rows = sorted(rows, key=lambda i: len(windows[i]))
        for lo in range(0, len(rows), 1024):  # bound the (B, Lmax) grids
            chunk = rows[lo : lo + 1024]
            Lmax = max(len(windows[i]) for i in chunk)
            lens_np = np.array([len(windows[i]) for i in chunk], dtype=np.int32)
            grid = np.zeros((len(chunk), Lmax), dtype=np.uint8)
            mask = np.arange(Lmax, dtype=np.int32)[None, :] < lens_np[:, None]
            grid[mask] = np.frombuffer(
                "".join(windows[i] for i in chunk).encode(), dtype=np.uint8
            )
            tchar = np.array([[ord(chars[i])] for i in chunk], dtype=np.uint8)
            found, first, length, cnt = _scan_np(grid == tchar, lens_np)
            for r, i in enumerate(chunk):
                if found[r]:
                    results[i] = (int(first[r]), int(length[r]), int(cnt[r]))

    n = len(windows)
    results: list[tuple[int, int, int] | None] = [None] * n
    host_score([i for i in range(n) if len(windows[i]) > MAX_WINDOW])

    buckets: dict[int, list[int]] = {}
    for i in range(n):
        lw = len(windows[i])
        if 0 < lw <= MAX_WINDOW:
            for edge in _L_BUCKETS:
                if lw <= edge:
                    buckets.setdefault(edge, []).append(i)
                    break
    # On the CPU backend the jitted scan's dispatch + O(L log L)
    # associative-scan work loses to the closed-form numpy twin (same
    # results -- _scan_np is equivalence-fuzzed against the per-window
    # scorer), so route everything through it there. A real accelerator
    # keeps the packed-transfer device path. FREDDIE_POLYA_DEVICE=1
    # forces the device path for its tests/benchmarks.
    host_all = False
    if buckets and not os.environ.get("FREDDIE_POLYA_DEVICE"):
        import jax

        host_all = jax.default_backend() == "cpu"
    fn = _get_scan() if buckets and not host_all else None
    pending = []  # (dev_rows, device handles) -- readbacks deferred so
    # every bucket's launch is in flight before the first sync.
    for L, rows_all in sorted(buckets.items()):
        if host_all:
            host_score(rows_all)
            continue
        for lo in range(0, len(rows_all), _MAX_ROWS):
            dev_rows = rows_all[lo : lo + _MAX_ROWS]
            B = _pad_rows(len(dev_rows))
            # Vectorized host packing: scatter the concatenated window
            # bytes into the padded (B, L) grid (row-major boolean
            # assignment lays them out window-by-window), compare against
            # each row's target char, bit-pack. No per-window Python
            # loop, and the transfer is L/8 bytes per row instead of 2L.
            lens_np = np.zeros(B, dtype=np.int32)
            lens_np[: len(dev_rows)] = [len(windows[i]) for i in dev_rows]
            grid = np.zeros((B, L), dtype=np.uint8)
            mask = np.arange(L, dtype=np.int32)[None, :] < lens_np[:, None]
            grid[mask] = np.frombuffer(
                "".join(windows[i] for i in dev_rows).encode(), dtype=np.uint8
            )
            tchar = np.zeros((B, 1), dtype=np.uint8)
            tchar[: len(dev_rows), 0] = [ord(chars[i]) for i in dev_rows]
            packed = np.packbits(grid == tchar, axis=1)
            pending.append((dev_rows, fn(jnp.asarray(packed), jnp.asarray(lens_np))))
    for dev_rows, (found, first, length, cnt) in pending:
        found = np.asarray(found)
        first = np.asarray(first)
        length = np.asarray(length)
        cnt = np.asarray(cnt)
        for r, i in enumerate(dev_rows):
            if found[r]:
                results[i] = (int(first[r]), int(length[r]), int(cnt[r]))
    return results


def annotate_gaps_and_polya_batch(items: list[tuple]) -> list[list[str]]:
    """Batched equivalent of ops.polya.annotate_gaps_and_polya over many
    reads: items are (data, segs, intervals, seq, strand) tuples; returns
    each read's sorted token list.

    All four scan requests per read (start/end window x A/T) across ALL
    items go to best_poly_batch in one pass, so a whole stage's polyA
    scoring runs as a handful of device launches. The A-vs-T selection
    reproduces the host's max-by-purity with first-listed (A) winning
    ties, in the same float64 arithmetic; token emission is the shared
    ops.polya.emit_tokens, so outputs are byte-identical to the host path
    (guarded by tests/test_polya_batch.py and the segment-stage
    equivalence test).
    """
    from .polya import _REV_COMP, clip_context, emit_tokens, poly_window

    ctxs: list[tuple | None] = []
    slots: list[dict[str, tuple[int, int] | None] | None] = []
    windows: list[str] = []
    chars: list[str] = []
    for data, segs, intervals, seq, strand in items:
        ctx = clip_context(data, segs, intervals, seq)
        ctxs.append(ctx)
        if ctx is None:
            slots.append(None)
            continue
        q_ssc, q_esc, _runs = ctx
        reqs: dict[str, tuple[int, int] | None] = {}
        for side, (lo, hi) in (("s", (0, q_ssc)), ("e", (q_esc, len(seq)))):
            if hi - lo < 20:
                # No run of length >= 20 fits: both scans are vacuous
                # (the host scorer would scan and find nothing).
                reqs[side] = None
                continue
            # One window string serves both scans: the A- and T-scan
            # windows are the same slice, only the scan char differs
            # (complemented, both strands).
            w, c_a = poly_window(seq, lo, hi, strand, "A")
            idx = len(windows)
            windows.append(w)
            chars.append(c_a)
            windows.append(w)
            chars.append(_REV_COMP[c_a])
            reqs[side] = (idx, idx + 1)
        slots.append(reqs)

    results = best_poly_batch(windows, chars)

    out: list[list[str]] = []
    for item, ctx, reqs in zip(items, ctxs, slots):
        if ctx is None:
            out.append([])
            continue
        data, segs, intervals, seq, strand = item
        q_ssc, q_esc, runs = ctx

        def select(side):
            if reqs[side] is None:
                return None
            best = None
            best_p = -1.0
            for char, ridx in zip(("A", "T"), reqs[side]):
                r = results[ridx]
                if r is None:
                    continue
                first, length, cnt = r
                p = cnt / length  # float64, the host's purity arithmetic
                if p > best_p:  # strict: A wins ties, like the host's max()
                    best_p = p
                    best = (first, length, char)
            return best

        out.append(
            emit_tokens(
                q_ssc, q_esc, runs, select("s"), select("e"), segs, intervals, len(seq)
            )
        )
    return out
