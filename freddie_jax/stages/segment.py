"""Stage 2 -- segment: canonical segmentation per tint + per-read 0/1/2 data.

Re-architects the reference's per-tint process pool
(py/freddie_segment.py:681-885) as a two-phase batch pipeline:

  Phase A (host, per tint): splice signal -> smoothing -> peak candidates ->
      cumulative coverage -> fixed breakpoints -> a list of DP problems.
  Phase B (device, batched): ALL problems from ALL tints are padded,
      bucketed and solved by the batched DP kernel (ops.segdp) -- this is
      where the FLOPs are, and it runs as a few large XLA launches instead
      of the reference's per-problem Python recursion.
  Phase C (per tint): union of breakpoints -> refinement -> genotyping
      (C1, host) -> per-read polyA/gap annotation (C2: one batched device
      scan over every read's soft-clip windows when the workload is big
      enough, host otherwise -- identical outputs) -> segment TSV (C3).

Results are bit-identical to solving each problem on the host oracle.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..config import SegmentConfig
from ..io.tsv import SplitTint, format_segment_tsv, load_read_sequences, parse_split_tsv
from ..utils.fsio import atomic_write
from ..ops import signal as sig
from ..ops.coverage import cumulative_coverage
from ..ops.polya import annotate_gaps_and_polya
from ..ops.segdp import (
    DPProblem,
    bucket_shape,
    collect_batch_device,
    dispatch_batch_device,
    solve_host,
    suggested_batch_size,
)
from ..ops.thresholds import ScaledThresholds

# Below this many reads the batched device polyA scorer is not worth its
# launches; the host scorer annotates inline during phase C1.
POLYA_DEVICE_MIN_READS = 512

# Below this much cumulative DP work (sum of P^3*R) the host oracle beats
# the device launches; the streaming driver flips to device dispatch
# the moment the running total crosses it.
DEVICE_MIN_WORK = 5_000_000

# Streaming chunk cap: buckets dispatch as soon as this many problems
# accumulate (or at suggested_batch_size if smaller), so launches overlap
# the rest of phase A instead of queueing behind it.
STREAM_CHUNK_MAX = 512

# Device-side coverage build engages from this many tints: below it the
# dense C transfer is a handful of chunks and the extra build launch
# costs more than the saved bytes; above, the interval lists win. The
# value comes from A/Bs on an earlier accelerator attachment and is not
# yet re-derived on the H100. The route is value-neutral either way;
# FREDDIE_DEVICE_COVERAGE=0/1 overrides.
DEVICE_COVERAGE_MIN_TINTS = 64

# A single background thread turns each dispatched chunk's device handle
# into a host numpy array as soon as the device finishes it, so the
# readback wait overlaps the rest of phase A (segcore loads, float
# surface) instead of serializing after it. Readback-ONLY: the thread
# spends its life blocked in jax's copy-to-host (GIL released); the
# round-3 experiment that moved prepare/finalize work to a thread
# measured slower from GIL churn and was reverted -- this design moves
# no Python work. Results are identical (np.asarray on the handle is the
# same synchronization collect_batch_device performs); exceptions
# re-raise in the main thread at collect time. FREDDIE_READBACK_THREAD=0
# disables.
READBACK_THREAD = True

# Auto-windowing: corpora with at least this many tints get a default
# stream_window (below) even when the config leaves it 0, so the
# resident capsule set stays bounded by default at 10M-100M scale. The
# window is deliberately huge -- it only exists to stop a problem parked
# in a rare (P, R) bucket from pinning every later tint through the
# in-order drain, and at 4096 tints per flush the partial-chunk launch
# overhead is noise. Byte-identical either way.
AUTO_WINDOW_MIN_TINTS = 20_000
AUTO_WINDOW = 4096

# In-flight launch cap: a chunk's device-resident footprint is dominated
# by its (B, P, R) int32 C input (up to ~70 MB); dispatching a large
# corpus's hundreds of chunks before the first readback parks every
# chunk's inputs in device memory at once. Collecting the OLDEST chunk
# inline once this many are pending bounds device memory (~1 GB) while
# keeping the launch/readback pipeline full; results are
# position-for-position the same solutions, so outputs are unchanged.
MAX_INFLIGHT_CHUNKS = 16


@dataclass
class _IntervalWork:
    y_raw: np.ndarray
    y_smooth: np.ndarray
    candidates: list[int]
    C: np.ndarray  # (P+1, R) cumulative coverage at candidates
    fixed: list[int]
    starts: np.ndarray | None  # read-rep interval starts (y-space)
    ends: np.ndarray | None
    reps: np.ndarray | None
    problems: list[int] = field(default_factory=list)  # global problem ids
    problem_bounds: list[tuple[int, int]] = field(default_factory=list)


@dataclass
class TintWork:
    tint: SplitTint
    weights: np.ndarray  # (R,) rep multiplicities
    intervals: list[_IntervalWork] = field(default_factory=list)


@dataclass
class NativeTintWork:
    """Phase A/C state for a tint held by the native engine
    (native/segcore.cpp): the capsule owns the parsed reads, rep
    structure and per-interval rows; Python keeps only what the float
    surface (scipy smoothing/peaks/refinement) and the device DP need."""

    handle: object  # segcore capsule
    chrom: str
    tint_id: int
    n_reads: int
    weights: np.ndarray
    intervals: list[_IntervalWork] = field(default_factory=list)


def build_splice_signal(tint: SplitTint, consider_ends: bool):
    """Raw splice signal per tint interval + per-interval read-rep interval
    arrays in y-space (py/freddie_segment.py:648-678).

    Fully vectorized: the flat (ts, te) matrix comes straight out of the
    rep keys via np.fromiter, per-interval metadata (rep index,
    multiplicity, first/last flags) via np.repeat over the key lengths,
    and one searchsorted maps every rep interval to its tint interval.
    Signal accumulation uses bincount; y_raw entries are integer-valued
    counts in float64, so the accumulation order cannot change the
    result. Returns (y_raws, per_iv) with per_iv[iv] either None or
    (ys, ye, rep) int64 arrays in y-space."""
    from itertools import chain

    iv_bounds = np.array(tint.intervals, dtype=np.int64)  # (n_iv, 2)
    y_raws = [np.zeros(e - s + 1) for s, e in tint.intervals]
    per_iv: list[tuple | None] = [None] * len(tint.intervals)
    n_reps = len(tint.read_reps)
    counts = np.fromiter(
        (len(k) for k, _ in tint.read_reps), dtype=np.int64, count=n_reps
    )
    total = int(counts.sum())
    if total == 0:
        return y_raws, per_iv
    flat = np.fromiter(
        chain.from_iterable(
            chain.from_iterable(k for k, _ in tint.read_reps)
        ),
        dtype=np.int64,
        count=2 * total,
    ).reshape(total, 2)
    ts_a, te_a = flat[:, 0], flat[:, 1]
    mults = np.fromiter(
        (len(r) for _, r in tint.read_reps), dtype=np.int64, count=n_reps
    )
    rep_a = np.repeat(np.arange(n_reps, dtype=np.int64), counts)
    mult_a = np.repeat(mults, counts).astype(np.float64)
    offsets = np.cumsum(counts)
    is_first = np.zeros(total, dtype=bool)
    is_first[offsets - counts] = True
    is_last = np.zeros(total, dtype=bool)
    is_last[offsets - 1] = True

    iv_a = np.searchsorted(iv_bounds[:, 0], ts_a, side="right") - 1
    s_a = iv_bounds[iv_a, 0]
    e_a = iv_bounds[iv_a, 1]
    assert np.all((s_a <= ts_a) & (ts_a <= te_a) & (te_a <= e_a))
    ys_a = ts_a - s_a
    ye_a = te_a - s_a
    start_on = is_first <= consider_ends  # consider_ends or not first
    end_on = is_last <= consider_ends
    for iv in range(len(tint.intervals)):
        m = iv_a == iv
        if not m.any():
            continue
        n_y = len(y_raws[iv])
        sm = m & start_on
        em = m & end_on
        y_raws[iv] += np.bincount(ys_a[sm], weights=mult_a[sm], minlength=n_y)
        y_raws[iv] += np.bincount(ye_a[em], weights=mult_a[em], minlength=n_y)
        per_iv[iv] = (ys_a[m], ye_a[m], rep_a[m])
    return y_raws, per_iv


def _float_surface(
    work, y_raws: list[np.ndarray], cfg: SegmentConfig, get_coverage,
    rows_of=None,
) -> list[DPProblem]:
    """Shared phase-A float surface: smoothing -> peaks -> fixed breakpoints
    -> DP problem slicing. ``get_coverage(iv_idx, cands) -> (P+1, R) int64``
    abstracts over the Python scatter/prefix-sum and the native engine.

    Appends per-interval work to ``work.intervals`` and returns the tint's
    DP problems (py/freddie_segment.py:679-720)."""
    smoothed, cand_lists = sig.smooth_and_candidates(y_raws, cfg.sigma)
    var_thr = sig.variance_threshold(smoothed, cfg.variance_factor)
    weights = work.weights
    problems: list[DPProblem] = []
    for iv_idx, (y_raw, y) in enumerate(zip(y_raws, smoothed)):
        cands = cand_lists[iv_idx]
        C = get_coverage(iv_idx, cands)
        fixed = {0, len(cands) - 1}
        # Vectorized threshold pass: identical comparisons to the
        # reference's per-candidate loop (NaN var_thr -> all False).
        fixed.update(
            int(c) for c in np.flatnonzero(y[np.asarray(cands, dtype=np.int64)] > var_thr)
        )
        fixed = sig.break_large_problems(cands, fixed, y, cfg.max_problem_size)
        fixed = sorted(fixed)
        starts = ends = reps = None
        if rows_of is not None:
            starts, ends, reps = rows_of(iv_idx)
        iw = _IntervalWork(
            y_raw=y_raw,
            y_smooth=y,
            candidates=cands,
            C=C,
            fixed=fixed,
            starts=starts,
            ends=ends,
            reps=reps,
        )
        cand_arr = np.array(cands, dtype=np.int64)
        for s_c, e_c in zip(fixed[:-1], fixed[1:]):
            iw.problems.append(len(problems))
            iw.problem_bounds.append((s_c, e_c))
            # Intervals overlapping the problem's candidate range: the
            # device-side coverage builder's input (intervals entirely
            # below the range contribute the same constant to every C
            # row and cancel in the kernels' differences; above: zero).
            iv_arr = None
            if starts is not None:
                y_first, y_last = cand_arr[s_c], cand_arr[e_c]
                m = (ends >= y_first) & (starts <= y_last - 1)
                iv_arr = np.stack(
                    [starts[m], ends[m], reps[m]], axis=1
                ).astype(np.int32)
            problems.append(
                DPProblem(
                    C=C[s_c : e_c + 1].copy(),
                    y=cand_arr[s_c : e_c + 1].copy(),
                    W=weights,
                    read_support=cfg.min_read_support_outside,
                    iv=iv_arr,
                )
            )
        work.intervals.append(iw)
    return problems


def prepare_tint_native(
    split_tsv: str, reads_tsv: str, cfg: SegmentConfig, thr: ScaledThresholds, eng
) -> tuple[NativeTintWork, list[DPProblem]]:
    """Phase A with the native engine: parse + splice signal + coverage run
    in C (native/segcore.cpp); only the float surface (scipy smoothing,
    peak finding) and the DP slicing stay in Python. Bit-identical to
    prepare_tint on the parsed equivalent (tests/test_segcore.py)."""
    caps, chrom, tint_id, _intervals, n_reads, n_reps, w_bytes, y_bytes = eng.load(
        split_tsv, reads_tsv, int(cfg.consider_ends)
    )
    weights = np.frombuffer(w_bytes, dtype=np.int64)
    assert len(weights) == n_reps
    y_raws = [np.frombuffer(b, dtype=np.float64) for b in y_bytes]
    work = NativeTintWork(
        handle=caps,
        chrom=chrom,
        tint_id=tint_id,
        n_reads=n_reads,
        weights=weights,
    )

    def get_coverage(iv_idx: int, cands: list[int]) -> np.ndarray:
        buf = eng.coverage(caps, iv_idx, [int(c) for c in cands])
        return np.frombuffer(buf, dtype=np.int64).reshape(len(cands) + 1, n_reps)

    def rows_of(iv_idx: int):
        ys_b, ye_b, rep_b = eng.rows(caps, iv_idx)
        return (
            np.frombuffer(ys_b, dtype=np.int64),
            np.frombuffer(ye_b, dtype=np.int64),
            np.frombuffer(rep_b, dtype=np.int64),
        )

    problems = _float_surface(work, y_raws, cfg, get_coverage, rows_of=rows_of)
    return work, problems


def final_positions_per_interval(
    work, solutions: list[list[int]], cfg: SegmentConfig
) -> list[list[int]]:
    """Assemble each interval's final breakpoint positions (y-space):
    fixed + DP-chosen candidates + the float refinement pass
    (py/freddie_segment.py:721-738). Shared by the Python and native
    finalization paths."""
    final_ys: list[list[int]] = []
    for iw in work.intervals:
        final_c = set(iw.fixed)
        for pid, (s_c, _e_c) in zip(iw.problems, iw.problem_bounds):
            final_c.update(s_c + local for local in solutions[pid])
        final_y = [iw.candidates[c] for c in sorted(final_c)]
        refine = sig.refine_segmentation(iw.y_raw, final_y, cfg.sigma)
        final_y.extend(refine)
        final_y.sort()
        final_ys.append([int(v) for v in final_y])
    return final_ys


def finalize_tint_native(
    work: NativeTintWork,
    solutions: list[list[int]],
    cfg: SegmentConfig,
    thr: ScaledThresholds,
    eng,
) -> bytes:
    """Phase C with the native engine: genotyping, polyA/gap annotation and
    TSV formatting in one C call; returns the segment TSV bytes
    (byte-identical to the Python finalize + format path)."""
    final_ys = final_positions_per_interval(work, solutions, cfg)
    lookup = np.ascontiguousarray(thr.lookup, dtype=np.int32)
    return eng.finalize(work.handle, final_ys, lookup.tobytes(), thr.scale)


def prepare_tint(tint: SplitTint, cfg: SegmentConfig, thr: ScaledThresholds) -> tuple[TintWork, list[DPProblem]]:
    weights = np.array([len(r) for _, r in tint.read_reps], dtype=np.int64)
    y_raws, per_iv = build_splice_signal(tint, cfg.consider_ends)
    work = TintWork(tint=tint, weights=weights)

    def rows_of(iv_idx: int):
        rows = per_iv[iv_idx]
        if rows is None:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        return rows

    def get_coverage(iv_idx: int, cands: list[int]) -> np.ndarray:
        starts, ends, reps = rows_of(iv_idx)
        return cumulative_coverage(
            starts, ends, reps, len(weights), np.array(cands), validate=cfg.validate
        )

    problems = _float_surface(work, y_raws, cfg, get_coverage, rows_of=rows_of)
    return work, problems


def solve_problems(problems: list[DPProblem], cfg: SegmentConfig, thr: ScaledThresholds) -> list[list[int]]:
    """Dispatch DP problems to the device kernel in size-bucketed batches
    (or the host oracle when use_device=False).

    Tiny workloads stay on the host: a device dispatch costs a fixed
    launch and readback while the host oracle solves a trivial problem in
    well under a millisecond, so the device only pays off for real
    batches of real problems."""
    if not cfg.use_device:
        return [solve_host(p, thr) for p in problems]
    total_work = sum(
        len(p.y) ** 3 * p.C.shape[1] for p in problems if len(p.y) > 2
    )
    if total_work < 5_000_000:  # ~a handful of small problems
        return [solve_host(p, thr) for p in problems]
    results: list[list[int] | None] = [None] * len(problems)
    # Bucket by padded (P, R) -- ops.segdp.bucket_shape, the single
    # definition shared with the streaming driver so the compiled
    # kernel-shape set stays identical everywhere.
    buckets: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(problems):
        if len(p.y) <= 2:
            results[i] = []
            continue
        buckets.setdefault(bucket_shape(len(p.y), p.C.shape[1]), []).append(i)
    # Dispatch EVERY bucket's launches before the first readback: device
    # dispatch is async, so the launches queue back to back instead of
    # waiting on each other (collect_batch_device's readback is the only
    # sync point).
    pending = []
    for (P, R), idxs in sorted(buckets.items()):
        bs = suggested_batch_size(P, R)
        for lo in range(0, len(idxs), bs):
            chunk = idxs[lo : lo + bs]
            handles, work, res = dispatch_batch_device(
                [problems[i] for i in chunk], thr, pad_p_to=P, pad_r_to=R
            )
            pending.append((chunk, handles, work, res))
    for chunk, handles, work, res in pending:
        for i, sol in zip(chunk, collect_batch_device(handles, work, res)):
            results[i] = sol
    return [r for r in results]  # type: ignore


def genotype_tint(
    work: TintWork,
    solutions: list[list[int]],
    cfg: SegmentConfig,
    thr: ScaledThresholds,
) -> tuple[list[int], list[tuple[int, int]]]:
    """Phase C1: assemble final breakpoints, refine, genotype.

    Fills read.data; returns (final genomic positions, segment pairs).
    PolyA/gap annotation is separate so the stage driver can batch every
    read's soft-clip scans in one device pass (ops.polya_batch)."""
    tint = work.tint
    n_reps = len(work.weights)
    final_positions: list[int] = []
    blocks: list[np.ndarray] = []  # per interval: (S, R) genotypes + 0-row
    scale = thr.scale
    final_ys = final_positions_per_interval(work, solutions, cfg)
    for iv_idx, (iw, final_y) in enumerate(zip(work.intervals, final_ys)):
        # Genotype every segment of the interval at once: coverage ratio
        # vs length threshold, in the exact scaled-integer comparisons.
        C2 = cumulative_coverage(
            iw.starts, iw.ends, iw.reps, n_reps, np.array(final_y), validate=cfg.validate
        )
        fy = np.asarray(final_y, dtype=np.int64)
        seg_len = fy[1:] - fy[:-1] + 1  # (S,)
        h = thr.high_scaled(seg_len).astype(np.int64)
        eq = thr.nay_eq_scaled(seg_len).astype(np.int64)
        # C2 is (len(final_y)+1, R); segments use rows 0..S only (row
        # S+1 is the coverage past the last breakpoint).
        covC = np.asarray(C2[: len(final_y)], dtype=np.int64)
        cov = covC[1:] - covC[:-1]
        if cfg.validate:
            assert np.all((0 <= cov) & (cov <= seg_len[:, None]))
        hi = scale * cov > (h * seg_len)[:, None]
        lo = scale * cov < ((scale - h) * seg_len + eq)[:, None]
        blocks.append(np.where(hi, 1, np.where(lo, 0, 2)).astype(np.int8))
        blocks.append(np.zeros((1, n_reps), np.int8))
        iv_s = tint.intervals[iv_idx][0]
        final_positions.extend(iv_s + y for y in final_y)

    cols = np.concatenate(blocks, axis=0).T  # (R, T)
    for data_row, (_, ridxs) in zip(cols, tint.read_reps):
        data = data_row.tolist()
        for ridx in ridxs:
            tint.reads[ridx].data = data.copy()
    segs = list(zip(final_positions[:-1], final_positions[1:]))
    for read in tint.reads:
        read.data.pop()
        assert len(read.data) == len(segs)
    return final_positions, segs


def finalize_tint(
    work: TintWork,
    solutions: list[list[int]],
    cfg: SegmentConfig,
    thr: ScaledThresholds,
) -> list[int]:
    """Phase C, single-tint path: genotype then host polyA/gap annotation.

    Returns the tint's final genomic positions; fills read.data/read.gaps.
    """
    final_positions, segs = genotype_tint(work, solutions, cfg, thr)
    for read in work.tint.reads:
        read.gaps = annotate_gaps_and_polya(
            read.data, segs, read.intervals, read.seq, read.strand
        )
    return final_positions


def segment_tint(tint: SplitTint, cfg: SegmentConfig, thr: ScaledThresholds | None = None) -> list[int]:
    """Single-tint convenience path (host or device)."""
    thr = thr or ScaledThresholds(cfg.threshold_rate)
    work, problems = prepare_tint(tint, cfg, thr)
    solutions = solve_problems(problems, cfg, thr)
    return finalize_tint(work, solutions, cfg, thr)


def dp_summary(engine: str, launches: int, host_problems: int) -> str:
    """The segment stage's one-line account of where phase B ran: the
    phase A/C engine, the number of device DP launches and of problems
    solved on the host, and -- when anything was launched -- the device
    count, peak device memory, backend and device kind."""
    line = (
        f"[segment] engine={engine} dp launches={launches} "
        f"host_problems={host_problems}"
    )
    if launches:
        import jax

        dev = jax.local_devices()[0]
        peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
        if peak is not None:
            line += f" peak_bytes={peak}"
        line += (
            f" devices={jax.local_device_count()} backend={dev.platform}"
            f" device_kind={dev.device_kind}"
        )
    return line


def run_segment(split_dir: str, outdir: str, cfg: SegmentConfig | None = None,
                owns=None, log=None) -> int:
    """Full segment stage over a split directory; returns #tints processed.

    All tints are prepared first (phase A), the union of their DP problems
    is solved in batched device launches (phase B), then each tint is
    finalized and written (phase C). ``owns(contig, tint_id) -> bool``
    restricts processing to this process's locus shard (multi-host).
    ``log``, when given, receives the dp_summary line."""
    cfg = cfg or SegmentConfig()
    os.makedirs(outdir, exist_ok=True)
    thr = ScaledThresholds(cfg.threshold_rate)
    jobs: list[tuple[str, int, str, str]] = []
    for contig in sorted(os.listdir(split_dir)):
        cdir = os.path.join(split_dir, contig)
        if not os.path.isdir(cdir):
            continue
        os.makedirs(os.path.join(outdir, contig), exist_ok=True)
        for fn in sorted(os.listdir(cdir)):
            if fn.startswith("split_") and fn.endswith(".tsv"):
                tint_id = int(fn[:-4].split("_")[-1])
                if owns is not None and not owns(contig, tint_id):
                    continue
                jobs.append(
                    (
                        contig,
                        tint_id,
                        os.path.join(cdir, fn),
                        os.path.join(cdir, f"reads_{contig}_{tint_id}.tsv"),
                    )
                )

    # Phase A runs SERIALLY: after the C parsers and the vectorized
    # signal/coverage rewrites, per-tint preparation is dominated by
    # GIL-holding work (C-extension parsing, small-array numpy), and a
    # thread pool only adds contention -- measured on the 26k-read bench
    # dataset: 0.74 s serial vs 1.38 s with 4 threads.
    #
    # Phases A and B are STREAMED: as soon as a (P, R) bucket accumulates a
    # chunk's worth of DP problems it is dispatched (async) to the device,
    # so launches overlap the remaining host preparation instead of waiting
    # for all of phase A; the collection loop then genotypes each tint the
    # moment its last problem is read back, overlapping phase C1 with the
    # still-in-flight launches. Identical solutions to the all-at-once path
    # (same bucketing, same kernels); only the schedule changes.
    from ..ops.segcore import load_segcore

    # Checked per call (not just in the loader) so tests/benches can flip
    # the env var after the extension is already cached in-process.
    eng = None if os.environ.get("FREDDIE_SEGCORE") == "0" else load_segcore()

    def prepare_one(job):
        _contig, _tint_id, split_tsv, reads_tsv = job
        if eng is not None:
            try:
                return prepare_tint_native(split_tsv, reads_tsv, cfg, thr, eng)
            except Exception:
                pass  # transparent fallback to the Python oracle path
        tint = parse_split_tsv(split_tsv)
        load_read_sequences(tint, reads_tsv)
        return prepare_tint(tint, cfg, thr)

    from ..utils.metrics import profile_trace

    works: list[TintWork] = []
    all_problems: list[DPProblem | None] = []
    offsets: list[int] = []
    solutions: list[list[int] | None] = []
    buckets: dict[tuple[int, int], list[int]] = {}
    pending: list = []  # (chunk_ids, handles, work, res, fut) in dispatch order
    readback = None
    if READBACK_THREAD and os.environ.get("FREDDIE_READBACK_THREAD") != "0":
        from concurrent.futures import ThreadPoolExecutor

        readback = ThreadPoolExecutor(1, thread_name_prefix="freddie-readback")
    total_work = 0  # cumulative DP cost seen so far (device-worth gate)
    device_on = False
    counts = {"launches": 0, "host": 0}  # for dp_summary

    # Incremental per-tint bookkeeping so finished tints finalize, WRITE
    # and free while later tints are still being prepared: memory stays
    # bounded by the in-flight window instead of the whole corpus (at
    # 10M reads the hold-everything schedule peaked at 44.6 GB RSS).
    unsolved: list[int] = []  # per tint: problems awaiting solutions
    tint_of: list[int] = []  # per problem
    finals: list = []  # per tint: ("done", None) once written, else result
    next_ready = 0  # tints are drained in order (deterministic, cheap)
    # The batched-polyA decision needs corpus totals; it only affects
    # Python-fallback tints, which therefore drain after phase A. The
    # cell is filled once totals are known (None = not yet decided).
    polya_cell = {"batch": None}

    full_chunks: set = set()  # buckets that dispatched a full chunk

    def chunk_size(P, R):
        # Power-of-two chunk (and batch pad) so the compiled-shape set
        # stays small and stable across datasets.
        bs = min(suggested_batch_size(P, R), STREAM_CHUNK_MAX)
        p2 = 8
        while p2 * 2 <= bs:
            p2 *= 2
        return p2

    def genotype_one(t):
        job, work, off = jobs[t], works[t], offsets[t]
        n = sum(len(iw.problems) for iw in work.intervals)
        sols = solutions[off : off + n]
        k = 0
        for iw in work.intervals:  # re-map local problem ids
            iw.problems = list(range(k, k + len(iw.problems)))
            k += len(iw.problems)
        if isinstance(work, NativeTintWork):
            try:
                out = finalize_tint_native(work, sols, cfg, thr, eng)
                work.handle = None  # free the C-side tint eagerly
                work.intervals = []
                return "tsv", out
            except Exception:
                # C-side invariant trip: redo this tint end to end on
                # the Python oracle path (phase A is deterministic, so
                # the shared solutions line up 1:1).
                _c, _t, split_tsv, reads_tsv = job
                tint = parse_split_tsv(split_tsv)
                load_read_sequences(tint, reads_tsv)
                pwork, _probs = prepare_tint(tint, cfg, thr)
                final_positions = finalize_tint(pwork, sols, cfg, thr)
                return "tsv", format_segment_tsv(tint, final_positions).encode()
        final_positions, segs = genotype_tint(work, sols, cfg, thr)
        if not polya_cell["batch"]:
            for read in work.tint.reads:
                read.gaps = annotate_gaps_and_polya(
                    read.data, segs, read.intervals, read.seq, read.strand
                )
        return final_positions, segs

    def write_tint(t, tsv_bytes):
        contig, tint_id = jobs[t][0], jobs[t][1]
        out_path = os.path.join(outdir, contig, f"segment_{contig}_{tint_id}.tsv")
        with atomic_write(out_path, "wb") as f:
            f.write(tsv_bytes)

    def drain_ready(allow_python: bool):
        # Finalize-and-write every leading tint whose problems are all
        # solved. Python-fallback tints stall the pointer until phase A
        # totals fix the polyA route (rare; native is the default), so
        # the common all-native corpus streams writes throughout.
        nonlocal next_ready
        while next_ready < len(finals) and unsolved[next_ready] == 0:
            if not (allow_python or isinstance(works[next_ready], NativeTintWork)):
                break
            result = genotype_one(next_ready)
            if result[0] == "tsv":
                write_tint(next_ready, result[1])
                finals[next_ready] = ("done", None)
            else:
                finals[next_ready] = result
            next_ready += 1

    n_collected = 0  # prefix of `pending` already read back inline

    def collect_oldest(allow_python: bool):
        nonlocal n_collected
        chunk, handles, wk, res, fut = pending[n_collected]
        if fut is not None:
            handles = fut.result()
        for gid, sol in zip(chunk, collect_batch_device(handles, wk, res)):
            solutions[gid] = sol
            unsolved[tint_of[gid]] -= 1
        # Drop the whole entry (frees the chip-side buffers); the final
        # collection loop skips None entries. A distinct sentinel, NOT
        # handles=None: dispatch_batch_device also returns handles=None
        # on its int32 scale-overflow host fallback, and those entries
        # must still flow through collect_batch_device below.
        pending[n_collected] = None
        n_collected += 1
        drain_ready(allow_python)

    def dispatch_chunks(key, force=False, allow_python=False):
        nonlocal pending
        idxs = buckets.get(key, [])
        P, R = key
        bs = chunk_size(P, R)
        while len(idxs) >= bs or (force and idxs):
            chunk, idxs = idxs[:bs], idxs[bs:]
            buckets[key] = idxs
            if len(chunk) == bs:
                full_chunks.add(key)
            # A final partial chunk of a bucket that already compiled the
            # full-chunk shape pads up to it: same executable, no fresh
            # compile (padding rows replicate problem 0, outputs unused).
            pad_b = bs if (key in full_chunks and len(chunk) < bs) else 0
            handles, wk, res = dispatch_batch_device(
                [all_problems[i] for i in chunk], thr, pad_p_to=P,
                pad_r_to=R, pad_b_to=pad_b,
                dev_cov=len(jobs) >= DEVICE_COVERAGE_MIN_TINTS,
            )
            for i in chunk:  # dispatched exactly once: free the C/iv copies
                all_problems[i] = None
            if handles is None:
                counts["host"] += len(chunk)
            else:
                counts["launches"] += 1
            fut = None
            if readback is not None and handles is not None:
                fut = readback.submit(np.asarray, handles)
            pending.append((chunk, handles, wk, res, fut))
            while len(pending) - n_collected > MAX_INFLIGHT_CHUNKS:
                collect_oldest(allow_python)

    # Windowed streaming (100M-scale memory bound): every `stream_window`
    # tints, flush every partial bucket so no problem -- and therefore no
    # tint capsule upstream of the in-order drain pointer -- waits for a
    # rare (P, R) bucket to fill. FREDDIE_SEGMENT_WINDOW overrides.
    stream_window = int(
        os.environ.get("FREDDIE_SEGMENT_WINDOW", cfg.stream_window) or 0
    )
    if not stream_window and len(jobs) >= AUTO_WINDOW_MIN_TINTS:
        stream_window = AUTO_WINDOW

    with profile_trace(os.environ.get("FREDDIE_TRACE_DIR")):
        for job in jobs:
            work, problems = prepare_one(job)
            off = len(all_problems)
            offsets.append(off)
            works.append(work)
            finals.append(None)
            all_problems.extend(problems)
            solutions.extend([None] * len(problems))
            tint_of.extend([len(works) - 1] * len(problems))
            n_unsolved = 0
            for gid in range(off, off + len(problems)):
                p = all_problems[gid]
                if len(p.y) <= 2:
                    solutions[gid] = []
                    continue
                n_unsolved += 1
                total_work += len(p.y) ** 3 * p.C.shape[1]
                key = bucket_shape(len(p.y), p.C.shape[1])
                buckets.setdefault(key, []).append(gid)
            unsolved.append(n_unsolved)
            if not device_on and cfg.use_device and total_work >= DEVICE_MIN_WORK:
                device_on = True
            if device_on:
                force = bool(
                    stream_window and len(works) % stream_window == 0
                )
                for key in list(buckets):
                    dispatch_chunks(key, force=force)

        # Phase A totals known: fix the batched-polyA route. The batched
        # device polyA pass only pays off when the C Kadane scorer is NOT
        # built: with it, per-read host scoring beat the device batch on
        # an earlier accelerator attachment (26k bench dataset: 1.38 s of
        # device launches/transfers vs ~0.4 s of C -- soft-clip scanning
        # is byte-twiddling, not matmul work). Outputs are
        # byte-identical on every route; FREDDIE_POLYA_DEVICE=1 forces
        # the device path (its tests/benches).
        total_reads = sum(
            len(w.tint.reads) for w in works if isinstance(w, TintWork)
        )
        batch_polya = cfg.use_device and total_reads >= POLYA_DEVICE_MIN_READS
        if batch_polya and not os.environ.get("FREDDIE_POLYA_DEVICE"):
            from ..ops.polya import _load_ctok

            ctok = _load_ctok()
            if ctok is not None and hasattr(ctok, "best_run"):
                batch_polya = False
            else:
                import jax

                batch_polya = jax.default_backend() != "cpu"
        polya_cell["batch"] = batch_polya

        if device_on:
            for key in sorted(buckets):
                dispatch_chunks(key, force=True, allow_python=True)
        else:
            # Tiny total workload (or use_device=False): the host oracle
            # beats the device round-trips; same results either way.
            for gid, sol in enumerate(solutions):
                if sol is None:
                    solutions[gid] = solve_host(all_problems[gid], thr)
                    unsolved[tint_of[gid]] -= 1
                    counts["host"] += 1

        # Collection + phase C1, interleaved: genotype (and write) every
        # tint whose problems are all solved, while later chunks are
        # still in flight.
        drain_ready(True)
        for entry in pending:
            if entry is None:
                continue  # read back inline under MAX_INFLIGHT_CHUNKS
            chunk, handles, wk, res, fut = entry
            if fut is not None:
                handles = fut.result()
            for gid, sol in zip(chunk, collect_batch_device(handles, wk, res)):
                solutions[gid] = sol
                unsolved[tint_of[gid]] -= 1
            drain_ready(True)
        assert next_ready == len(finals)
        if readback is not None:
            readback.shutdown(wait=False)
        triples = list(zip(jobs, works, offsets))

    # Phase C2 (device, batched): every read's polyA soft-clip scans across
    # ALL tints in one bucketed launch set (ops.polya_batch); byte-identical
    # to the host path (tests/test_polya_batch.py, test_segment_polya_device).
    if batch_polya:
        from ..ops.polya_batch import annotate_gaps_and_polya_batch

        items = []
        owners = []
        for (_, work, _), (_fp, segs) in zip(triples, finals):
            if not isinstance(work, TintWork):
                continue  # native tints annotate inside the C finalizer
            for read in work.tint.reads:
                items.append((read.data, segs, read.intervals, read.seq, read.strand))
                owners.append(read)
        for read, toks in zip(owners, annotate_gaps_and_polya_batch(items)):
            read.gaps = toks

    # Phase C3: write the remaining TSVs (native tints were written the
    # moment they finalized; "done" marks them).
    for ((contig, tint_id, _, _), work, _off), (head, tail) in zip(
        triples, finals
    ):
        if head == "done":
            continue
        out_path = os.path.join(outdir, contig, f"segment_{contig}_{tint_id}.tsv")
        if head == "tsv":
            with atomic_write(out_path, "wb") as f:
                f.write(tail)
        else:
            with atomic_write(out_path) as f:
                f.write(format_segment_tsv(work.tint, head))
    if log is not None:
        log(dp_summary("python" if eng is None else "native",
                       counts["launches"], counts["host"]))
    return len(jobs)
