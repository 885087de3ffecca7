"""Stage 3 -- cluster: exact read->isoform assignment per tint.

Reproduces the reference's clustering pipeline (py/freddie_cluster.py)
with the Gurobi ILP swapped for the deterministic exact solver:

  1. preprocess: I/C/FL matrices, polyA-tail promotion to virtual gaps,
     garbage costs (:277-328);
  2. partition: dedup identical structures, pairwise-compatibility graph,
     iterative edge pruning, connected components, even splitting at
     max_ilp (:196-274);
  3. per partition, up to max_rounds greedy rounds, each peeling off the
     single optimal isoform (K=2: garbage + one real) and removing its
     reads (:694-773);
  4. cluster TSV output (:639-691).

Tie-breaking note: ILP optima need not be unique and Gurobi's choice is
unspecified; this implementation fixes a deterministic rule (first optimum
in heaviest-garbage-first assign-first DFS order, strict improvement), so
outputs are bit-reproducible across runs and platforms.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from math import ceil

import numpy as np

from ..config import ClusterConfig
from ..io.tsv import SegTint, format_cluster_tsv, parse_segment_tsv
from ..solver.exact import ClusterInstance, SolveResult


def _solve(inst: ClusterInstance, deadline_s: float) -> SolveResult:
    """LP-assisted two-phase exact solve over the native C++ core (with
    Python fallback); result-identical to the plain search (see
    solver.two_phase)."""
    from ..solver.two_phase import solve_two_phase

    return solve_two_phase(inst, deadline_s)


@dataclass
class IlpData:
    """Per-tint solver inputs at read-rep granularity. I and C are
    (N, M) uint8 matrices (row indexing keeps the reference's
    list-of-rows shape: ilp.I[i][j])."""

    I: np.ndarray  # noqa: E741 -- name matches the reference
    C: np.ndarray
    FL: list[tuple[int, int]]
    garbage: list[float]
    gaps: list[dict]  # per rep: {(j1, j2): l} including virtual tail gaps
    # Flat per-tint gap arrays (rep-major, dict order within a rep):
    # the same data as `gaps`, pre-flattened once so build_instance's
    # per-round packaging is pure index arithmetic instead of Python
    # dict loops.
    gap_rep: np.ndarray = None  # (G,) int64 rep index
    gap_j1: np.ndarray = None  # (G,) int64
    gap_j2: np.ndarray = None  # (G,) int64
    gap_l: np.ndarray = None  # (G,) int64


def first_last_covered(I_row: list[int]) -> tuple[int, int]:
    """First/last segment with value 1 (py/freddie_cluster.py:175-183;
    note the reference's defaults: (-1, M-1) when the row has no 1s)."""
    min_i, max_i = -1, len(I_row) - 1
    for j, v in enumerate(I_row):
        if v == 1:
            if min_i == -1:
                min_i = j
            max_i = j
    return min_i, max_i


def preprocess(tint: SegTint, cfg: ClusterConfig) -> IlpData:
    M = len(tint.segs)
    I, C, FL, garbage, gaps = [], [], [], [], []
    for rep_idx, ridxs in enumerate(tint.read_reps):
        read = tint.reads[ridxs[0]]
        I_row = [d % 2 for d in read.data]
        min_i, max_i = first_last_covered(I_row)
        category = "N"
        rep_gaps = dict(read.gaps)
        if len(read.poly_tail) == 1:
            tail_key, tail_val = next(iter(read.poly_tail.items()))
            if tail_key in ("SA", "ST") and tail_val[0] > 10:
                category = "S"
                rep_gaps[(-1, min_i)] = tail_val[1]
                min_i = 0
            elif tail_key in ("EA", "ET") and tail_val[0] > 10:
                category = "E"
                rep_gaps[(max_i, M)] = tail_val[1]
                max_i = M - 1
        C_row = [
            1 if (min_i <= j <= max_i and read.data[j] == 0) else 0 for j in range(M)
        ]
        if cfg.recycle_model == "constant":
            g = len(ridxs) * 3
        elif cfg.recycle_model == "exons":
            g = len(ridxs) * max(sum(I_row) - 0.5, 1)
        elif cfg.recycle_model == "introns":
            g = len(ridxs) * max(sum(C_row) - 0.5, 1)
        else:
            raise NotImplementedError(
                "recycle_model='relative' requires the K>2 objective; "
                "the reference pins K=2 (py/freddie_cluster.py:790)"
            )
        I.append(I_row)
        C.append(C_row)
        FL.append((min_i, max_i))
        garbage.append(g)
        gaps.append(rep_gaps)
        for ridx in ridxs:
            tint.reads[ridx].poly_tail_category = category
            tint.reads[ridx].gaps = rep_gaps
    shape = (len(I), M)
    flat = [
        (k, j1, j2, l)
        for k, rep_gaps in enumerate(gaps)
        for (j1, j2), l in rep_gaps.items()
    ]
    ga = np.array(flat, dtype=np.int64).reshape(-1, 4)
    return IlpData(
        I=np.array(I, dtype=np.uint8).reshape(shape),
        C=np.array(C, dtype=np.uint8).reshape(shape),
        FL=FL,
        garbage=garbage,
        gaps=gaps,
        gap_rep=ga[:, 0],
        gap_j1=ga[:, 1],
        gap_j2=ga[:, 2],
        gap_l=ga[:, 3],
    )


def split_list_evenly(l: list, m: int):
    p = ceil(len(l) / m)
    s = ceil(len(l) / p)
    for idx in range(0, p * s, s):
        yield l[idx : idx + s]


def partition_reads(
    tint: SegTint, ilp: IlpData, max_ilp: int
) -> list[tuple[list[int], list[tuple[int, int]]]]:
    """Partitions of rep ids + per-partition incompatible pairs
    (py/freddie_cluster.py:196-274)."""
    reads = tint.reads
    reps = tint.read_reps
    N_reps = len(reps)
    M = ilp.I.shape[1]

    unique: dict[tuple, list[int]] = {}
    for i in range(N_reps):
        d = (
            ilp.I[i].tobytes(),
            (ilp.FL[i][0], ilp.FL[i][1], reads[reps[i][0]].poly_tail_category),
        )
        unique.setdefault(d, []).append(i)
    unique_items = list(unique.items())
    N = len(unique_items)

    # Pairwise compatibility, vectorized over bit-packed structures. For a
    # pair, the reference compares I values on the overlap window
    # [max(f1,f2), min(l1,l2)] (py/freddie_cluster.py:196-242). That
    # window is exactly the intersection of the two reads' [f, l] ranges
    # (f clipped to 0: f = -1 only for all-zero rows, whose pairs are
    # dropped by the w >= 1 gate in both formulations), so with per-read
    # validity masks V and exon masks E over uint64 words:
    #   o = popcount(V1 & V2), w = popcount(E1 & E2 & V1 & V2),
    #   diff = popcount((E1 ^ E2) & V1 & V2).
    first_member = [members[0] for _d, members in unique_items]
    f_arr = np.array([k[1][0] for k, _ in unique_items], dtype=np.int64)
    l_arr = np.array([k[1][1] for k, _ in unique_items], dtype=np.int64)
    cat = np.array(
        [{"N": 0, "S": 1, "E": 2}[k[1][2]] for k, _ in unique_items],
        dtype=np.int8,
    )
    E_bool = ilp.I[first_member] == 1  # (N, M)
    pos = np.arange(M, dtype=np.int64)[None, :]
    V_bool = (pos >= np.maximum(f_arr, 0)[:, None]) & (pos <= l_arr[:, None])
    W = max((M + 63) // 64, 1)

    def pack(mat: np.ndarray) -> np.ndarray:
        padded = np.zeros((N, W * 64), dtype=bool)
        padded[:, :M] = mat
        return np.packbits(padded, axis=1, bitorder="little").view(np.uint64)

    Ew = pack(E_bool)
    Vw = pack(V_bool)
    # All pairs at once, chunked over rows to bound the (block, N, W)
    # temporaries; strict upper triangle via the column > row mask.
    edge_parts: list[np.ndarray] = []
    BLK = max(1, (1 << 22) // max(N * W, 1))  # ~32 MB of u64 temporaries
    cols = np.arange(N)
    for lo in range(0, N - 1, BLK):
        hi = min(lo + BLK, N - 1)
        rows_ = slice(lo, hi)
        vi = Vw[rows_, None, :] & Vw[None, :, :]  # (b, N, W)
        o = np.bitwise_count(vi).sum(axis=2, dtype=np.int64)
        w = np.bitwise_count(Ew[rows_, None, :] & Ew[None, :, :] & vi).sum(
            axis=2, dtype=np.int64
        )
        diff = np.bitwise_count(
            (Ew[rows_, None, :] ^ Ew[None, :, :]) & vi
        ).sum(axis=2, dtype=np.int64)
        ok = (w >= 1) & (
            ((o > 3) & (diff < 3)) | ((o >= 1) & (o <= 3) & (diff == 0))
        )
        ci = cat[lo:hi, None]
        ok &= ~((ci != 0) & (cat[None, :] != 0) & (cat[None, :] != ci))
        ok &= cols[None, :] > np.arange(lo, hi)[:, None]
        bi, bj = np.nonzero(ok)
        edge_parts.append(np.stack([bi + lo, bj], axis=1))

    edges_arr = (
        np.concatenate(edge_parts, axis=0)
        if edge_parts
        else np.zeros((0, 2), dtype=np.int64)
    )
    e_i = edges_arr[:, 0].astype(np.int64)
    e_j = edges_arr[:, 1].astype(np.int64)

    # Iterative pruning: drop an edge unless an endpoint has no other
    # neighbor or the pair shares a neighbor; sweep until stable. Each
    # sweep evaluates every live edge against the adjacency as it stood
    # at the sweep's start (same synchronous semantics as the original
    # set-based loop), vectorized over a bit-packed adjacency matrix.
    Wp = max((N + 63) // 64, 1)
    adjw = np.zeros((N, Wp), dtype=np.uint64)
    np.bitwise_or.at(adjw, (e_i, e_j >> 6), np.uint64(1) << (e_j & 63).astype(np.uint64))
    np.bitwise_or.at(adjw, (e_j, e_i >> 6), np.uint64(1) << (e_i & 63).astype(np.uint64))
    deg = np.bincount(e_i, minlength=N) + np.bincount(e_j, minlength=N)
    alive_mask = np.ones(len(e_i), dtype=bool)
    while True:
        live = np.flatnonzero(alive_mask)
        if not len(live):
            break
        li, lj = e_i[live], e_j[live]
        shared = (adjw[li] & adjw[lj]).any(axis=1)
        rm = (deg[li] != 1) & (deg[lj] != 1) & ~shared
        if not rm.any():
            break
        drop = live[rm]
        alive_mask[drop] = False
        di, dj = e_i[drop], e_j[drop]
        np.bitwise_and.at(adjw, (di, dj >> 6), ~(np.uint64(1) << (dj & 63).astype(np.uint64)))
        np.bitwise_and.at(adjw, (dj, di >> 6), ~(np.uint64(1) << (di & 63).astype(np.uint64)))
        deg -= np.bincount(di, minlength=N) + np.bincount(dj, minlength=N)

    # Connected components (ordered by smallest member, like nx's iteration
    # over nodes 0..N-1).
    parent = list(range(N))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    live = np.flatnonzero(alive_mask)
    for i, j in zip(e_i[live].tolist(), e_j[live].tolist()):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    comps: dict[int, list[int]] = {}
    for i in range(N):
        comps.setdefault(find(i), []).append(i)

    adj_mat = np.zeros((N, N), dtype=bool)
    adj_mat[e_i[live], e_j[live]] = True
    adj_mat[e_j[live], e_i[live]] = True
    # Flat member table: unique u's rep ids at mem_flat[mem_off[u]:+sz[u]].
    sz = np.array([len(m) for _d, m in unique_items], dtype=np.int64)
    mem_off = np.concatenate([[0], np.cumsum(sz)[:-1]]).astype(np.int64)
    mem_flat = np.array(
        [r for _d, m in unique_items for r in m], dtype=np.int32
    )

    def expand_nonedges(c_arr: np.ndarray) -> np.ndarray:
        """Read-level incompatible pairs of one partition: for every
        unordered unique pair in c_arr without a surviving edge, the full
        cross product of their member rep ids -- pair-major, r1-major,
        exactly the reference's nested loops -- computed with O(total)
        index arithmetic instead of per-pair Python."""
        U = len(c_arr)
        if U < 2:
            return np.zeros((0, 2), dtype=np.int32)
        ii, jj = np.triu_indices(U, 1)
        ci, cj = c_arr[ii], c_arr[jj]  # c_arr ascending => ci < cj
        ne = ~adj_mat[ci, cj]
        ai, bi = ci[ne], cj[ne]
        if len(ai) == 0:
            return np.zeros((0, 2), dtype=np.int32)
        sa, sb = sz[ai], sz[bi]
        # r1: each member of A repeated |B| times, pairs concatenated.
        na = int(sa.sum())
        a_local = np.arange(na, dtype=np.int64) - np.repeat(
            np.cumsum(sa) - sa, sa
        )
        a_elems = mem_flat[np.repeat(mem_off[ai], sa) + a_local]
        r1 = np.repeat(a_elems, np.repeat(sb, sa))
        # r2: B cycled within each pair's |A|*|B| block.
        block = sa * sb
        total = int(block.sum())
        pos = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(block) - block, block
        )
        b_local = pos % np.repeat(sb, block)
        r2 = mem_flat[np.repeat(mem_off[bi], block) + b_local]
        return np.stack([r1, r2], axis=1)

    partitions = []
    for root in sorted(comps, key=lambda r: min(comps[r])):
        comp = sorted(comps[root])
        for c in split_list_evenly(comp, max_ilp):
            rids: list[int] = []
            for i in c:
                rids.extend(unique_items[i][1])
            partitions.append(
                (rids, expand_nonedges(np.asarray(c, dtype=np.int64)))
            )
    return partitions


def informative_segs(tint: SegTint, ilp: IlpData, remaining: list[int]) -> list[bool]:
    """A middle segment is uninformative when its value is constant across
    the remaining reads and equals both neighbors
    (py/freddie_cluster.py:331-344)."""
    M = len(tint.segs)
    sub = ilp.I[remaining]  # (n, M)
    ref = sub[0]
    const = (sub == ref[None, :]).all(axis=0)  # column is single-valued
    informative = np.ones(M, dtype=bool)
    if M > 2:
        informative[1:-1] = ~(
            const[:-2] & const[1:-1] & const[2:]
            & (ref[:-2] == ref[1:-1]) & (ref[1:-1] == ref[2:])
        )
    return informative.tolist()


def build_instance(
    tint: SegTint,
    ilp: IlpData,
    remaining: list[int],
    incomp: list[tuple[int, int]],
    informative: list[bool],
    cfg: ClusterConfig,
) -> ClusterInstance:
    """Restrict the round's data to informative segments and package it for
    the solver."""
    M = len(tint.segs)
    inf_idx = np.flatnonzero(informative)
    Mi = len(inf_idx)
    seg_len = np.array([tint.segs[j][2] for j in inf_idx], dtype=np.int64)
    # Informative-column slices for the whole round at once.
    sub_I = ilp.I[remaining][:, inf_idx] == 1  # (n, Mi)
    sub_C = ilp.C[remaining][:, inf_idx] == 1
    pos_map = np.full(ilp.I.shape[0], -1, dtype=np.int64)
    pos_map[np.asarray(remaining, dtype=np.int64)] = np.arange(len(remaining))
    # Gaps of the remaining reps straight from the per-tint flat arrays
    # (pre-flattened in preprocess): pure index arithmetic, no Python
    # dict loops. Partitions concatenate unique-group members, so
    # `remaining` need not be ascending -- a stable sort by round
    # position restores the row-major order the solver ABI requires
    # (and preserves each rep's dict order within its row).
    k_of = pos_map[ilp.gap_rep]
    gsel = np.flatnonzero(k_of >= 0)
    gsel = gsel[np.argsort(k_of[gsel], kind="stable")]
    gap_owner = k_of[gsel]
    lens = ilp.gap_l[gsel]
    los = np.searchsorted(inf_idx, ilp.gap_j1[gsel] + 1)
    his = np.searchsorted(inf_idx, ilp.gap_j2[gsel])
    # Re-index surviving incompatible pairs into round positions. The
    # construction in partition_reads never emits duplicates, and every
    # solver consumes the pairs as an (unordered) constraint set, so no
    # dedup pass is needed.
    inc = np.asarray(incomp, dtype=np.int64).reshape(-1, 2)
    pa = pos_map[inc[:, 0]]
    pb = pos_map[inc[:, 1]]
    keep = (pa >= 0) & (pb >= 0)
    pairs = np.stack([pa[keep], pb[keep]], axis=1).astype(np.int32)
    return ClusterInstance(
        rows=None,  # lazily materialized from the flat arrays on demand
        seg_len=seg_len,
        incomp=pairs,
        epsilon=cfg.epsilon,
        offset=cfg.gap_offset,
        exons_mat=sub_I,
        corr_mat=sub_C,
        # Flat-array form for the consolidated native round solver: gap
        # windows as [lo, hi) informative-column ranges, row-major (the
        # gap_owner loop above iterates rounds' rows in order).
        garbage_arr=np.array([ilp.garbage[i] for i in remaining], dtype=np.float64),
        gap_counts=np.bincount(
            np.asarray(gap_owner, dtype=np.int64), minlength=len(remaining)
        ).astype(np.int32),
        gap_lo=los.astype(np.int32),
        gap_hi=his.astype(np.int32),
        gap_len_arr=np.asarray(lens, dtype=np.int64),
    )


def cluster_tint(
    tint: SegTint, cfg: ClusterConfig, instance_hook=None
) -> tuple[list[dict], list[int]]:
    """Full per-tint clustering; returns (isoforms, garbage_rep_ids) and
    fills read.partition / poly_tail_category. instance_hook(inst) is
    called for every solver instance (used by the optimum-uniqueness
    audit, tools/audit_tiebreak.py)."""
    import time as _time

    from ..utils.metrics import SolverLog

    ilp = preprocess(tint, cfg)
    partitions = partition_reads(tint, ilp, cfg.max_ilp)
    M = len(tint.segs)
    isoforms: list[dict] = []
    garbage_rids: list[int] = []
    slog = SolverLog(cfg.logs_dir, tint.id)

    for p_idx, (remaining, incomp) in enumerate(partitions):
        for rep_id in remaining:
            for ridx in tint.read_reps[rep_id]:
                tint.reads[ridx].partition = p_idx
        remaining = list(remaining)
        for _round in range(cfg.max_rounds):
            mult_left = sum(len(tint.read_reps[i]) for i in remaining)
            if mult_left < cfg.min_isoform_size:
                break
            informative = informative_segs(tint, ilp, remaining)
            inst = build_instance(tint, ilp, remaining, incomp, informative, cfg)
            if instance_hook is not None:
                instance_hook(inst)
            slog.dump_instance(p_idx, _round, inst)
            t0 = _time.perf_counter()
            res = _solve(inst, deadline_s=cfg.timeout * 60.0)
            slog.record(p_idx, _round, len(remaining), res, _time.perf_counter() - t0)
            slog.dump_solution(p_idx, _round, res)
            if res.status != "OPTIMAL":
                break
            assigned_pos = set(res.assigned)
            assigned = [r for p, r in enumerate(remaining) if p in assigned_pos]
            assigned_mult = sum(len(tint.read_reps[i]) for i in assigned)
            if assigned_mult < cfg.min_isoform_size:
                break
            # Isoform exon bitstring: solver E on informative segments; the
            # (constant) read value elsewhere (py/freddie_cluster.py:602-610).
            inf_idx = [j for j in range(M) if informative[j]]
            col_of = {j: c for c, j in enumerate(inf_idx)}
            ref_row = ilp.I[min(remaining)]
            exons = [
                int(res.isoform[col_of[j]]) if informative[j] else int(ref_row[j])
                for j in range(M)
            ]
            rid_to_corrections = {}
            for rep_id in assigned:
                data = tint.reads[tint.read_reps[rep_id][0]].data
                corrections = [
                    "-"
                    if not informative[j]
                    else (
                        "X"
                        if ilp.C[rep_id][j] == 1 and exons[j] == 1
                        else str(data[j])
                    )
                    for j in range(M)
                ]
                rid_to_corrections[rep_id] = corrections
            isoforms.append(dict(exons=exons, rid_to_corrections=rid_to_corrections))
            assigned_set = set(assigned)
            remaining = [r for r in remaining if r not in assigned_set]
        garbage_rids.extend(sorted(remaining))
    slog.close()
    return isoforms, garbage_rids


# Process-pool gate: segment-TSV bytes above which the spawn pool's
# multi-second worker startup amortizes. ~2.7 s of stage work per MB
# measured on the 300k corpus (23 MB -> 63 s serial); at 8 MB the pool
# saves ~3x its startup on 4 cores.
POOL_MIN_BYTES = 8 << 20


def _worker_init() -> None:
    """Process-pool worker setup: pin JAX to the host CPU backend. The
    parent owns the accelerator (a second JAX process on it would fail
    for want of memory); a worker that reaches the solver's
    device-assisted wide path uses CPU-XLA, which is value-identical (the
    device path asserts bit-equality) and fast at the sizes that survive
    the reference's partitioning caps.

    jax is usually NOT imported yet in a fresh worker -- then the env var
    alone pins any lazy import. If something pre-imported jax anyway (a
    driver script importing jax at module scope), fall back to
    config.update, which works after import where the env var would be
    too late."""
    import sys

    os.environ["JAX_PLATFORMS"] = "cpu"
    if "jax" in sys.modules:
        import jax

        jax.config.update("jax_platforms", "cpu")


def _cluster_one(job: tuple[str, str, str, "ClusterConfig"]) -> int:
    in_path, out_path, contig, cfg = job
    # Idempotent per-tint resume: outputs are deterministic, so an
    # existing file is a completed shard (SURVEY.md section 5 checkpoint
    # semantics; the pipeline driver removes stage dirs on forced reruns).
    if os.path.exists(out_path):
        return 1
    if cfg.logs_dir is not None:
        # Scope solver logs per contig (tint ids repeat across contigs),
        # like the reference's '{logs_dir}/{contig}' (py/freddie_cluster.py:813).
        import dataclasses

        cfg = dataclasses.replace(cfg, logs_dir=os.path.join(cfg.logs_dir, contig))
    else:
        # Consolidated native engine: the whole tint (parse through TSV)
        # in one C call against the in-process solver twins. Returns None
        # when any round needs a Python escalation rung; raises on any
        # invariant trip -- both fall through to the Python oracle path
        # below with byte-identical output (tests/test_clucore.py).
        # logs_dir forces the Python path (per-instance observability).
        from ..solver.clucore import cluster_tint_native
        from ..utils.fsio import atomic_write

        try:
            out = cluster_tint_native(in_path, cfg)
        except Exception:
            out = None
        if out is not None:
            with atomic_write(out_path, "wb") as f:
                f.write(out)
            return 1
    tint = parse_segment_tsv(in_path)
    isoforms, garbage = cluster_tint(tint, cfg)
    # Atomic: the per-tint resume above trusts an existing file, so a
    # crash mid-write must not leave a truncated one.
    from ..utils.fsio import atomic_write

    with atomic_write(out_path) as f:
        f.write(format_cluster_tsv(tint, isoforms, garbage))
    return 1


def run_cluster(segment_dir: str, outdir: str, cfg: ClusterConfig | None = None,
                owns=None) -> int:
    """Full cluster stage over a segment directory; returns #tints.

    ``owns(contig, tint_id) -> bool`` restricts to this process's shard.

    Tints are independent; with cfg.threads > 1 they run on a thread pool
    (the C++ branch-and-bound core releases the GIL for the duration of
    each solve, so threads scale the reference's process-pool parallelism
    without pickling)."""
    cfg = cfg or ClusterConfig()
    os.makedirs(outdir, exist_ok=True)
    jobs = []
    for contig in sorted(os.listdir(segment_dir)):
        cdir = os.path.join(segment_dir, contig)
        if not os.path.isdir(cdir):
            continue
        os.makedirs(os.path.join(outdir, contig), exist_ok=True)
        # Sweep stray .tmp files from a crashed previous run (atomic
        # writes never publish them; they are just disk litter). Only
        # THIS process's shard: on a shared filesystem another host may
        # be mid-write on its own tints, and deleting its live .tmp
        # makes its os.replace fail (race found by the 2-process
        # pipeline scaling bench).
        out_cdir = os.path.join(outdir, contig)
        for fn in os.listdir(out_cdir):
            if fn.endswith(".tsv.tmp"):
                try:
                    tid = int(fn[: -len(".tsv.tmp")].split("_")[-1])
                except ValueError:
                    continue
                if owns is None or owns(contig, tid):
                    os.remove(os.path.join(out_cdir, fn))
        for fn in sorted(os.listdir(cdir)):
            if not (fn.startswith("segment_") and fn.endswith(".tsv")):
                continue
            tint_id = int(fn[:-4].split("_")[-1])
            if owns is not None and not owns(contig, tint_id):
                continue
            jobs.append(
                (
                    os.path.join(cdir, fn),
                    os.path.join(outdir, contig, f"cluster_{contig}_{tint_id}.tsv"),
                    contig,
                    cfg,
                )
            )
    # Parallel dispatch. Per-tint packaging (TSV parse, partition graph,
    # instance build) is Python/numpy holding the GIL, so a thread pool
    # serializes ~1/3 of the stage; a spawn process pool scales it too.
    # Spawned workers each pay an interpreter + package import, so the
    # pool is gated to inputs big enough to amortize it; per-tint outputs are deterministic files, so the two
    # paths (and a broken pool falling back mid-stage -- completed tints
    # resume idempotently) are byte-identical.
    total_bytes = sum(os.path.getsize(p) for p, _o, _c, _cfg in jobs)
    pooled = False
    if cfg.threads > 1 and len(jobs) > 1 and total_bytes > POOL_MIN_BYTES:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        from concurrent.futures.process import BrokenProcessPool

        # NOTE for script authors: spawn workers re-import __main__, so a
        # driver script calling run_cluster MUST guard its top level with
        # `if __name__ == "__main__":` (standard multiprocessing rule;
        # same as the isoforms pool -- an unguarded rmtree at module
        # scope would re-execute inside every worker).
        #
        # Biggest inputs first: tint wall time tracks input size, and a
        # multi-second tint scheduled last would own the stage's tail.
        order = sorted(
            range(len(jobs)), key=lambda k: -os.path.getsize(jobs[k][0])
        )
        from ..utils.procenv import cpu_worker_env

        try:
            # spawn, not fork: the parent may hold JAX's threads. The
            # scoped env keeps workers off the accelerator
            # (utils/procenv.py).
            with cpu_worker_env(), ProcessPoolExecutor(
                max_workers=cfg.threads,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_worker_init,
            ) as ex:
                n = sum(ex.map(_cluster_one, [jobs[k] for k in order],
                               chunksize=4))
            pooled = True
        except BrokenProcessPool:
            pass
    if not pooled:
        if cfg.threads > 1 and len(jobs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=cfg.threads) as ex:
                n = sum(ex.map(_cluster_one, jobs))
        else:
            n = sum(_cluster_one(j) for j in jobs)
    if cfg.logs_dir is not None:
        # Stage-level roll-up of every tint's solver status table (the
        # .sol/.glog-era reader's "how did the solver do overall").
        import json as _json

        from ..utils.metrics import summarize_solver_logs

        with open(os.path.join(cfg.logs_dir, "solver_summary.json"), "w") as f:
            _json.dump(summarize_solver_logs(cfg.logs_dir), f, indent=1)
    return n
