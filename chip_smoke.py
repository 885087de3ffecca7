#!/usr/bin/env python3
"""Smoke run of freddie-jax on NVIDIA GPUs: the production path, checked.

    python chip_smoke.py              # one card
    python chip_smoke.py --multi      # four cards: the sharded paths only

One card (the first, unless CUDA_VISIBLE_DEVICES names another). Each
phase prints one line:

- card: `nvidia-smi` name and power limit;
- preflight: JAX version, devices (must be GPUs), memory limit;
- dp: the production jitted DP (ops.segdp._get_jitted: _solve_batch_jax
  + _walk_chains) compiled for the card at each (B, P, R) bucket edge,
  with narrow (<= 127) and wide (up to 16,383) rep weights; compile
  seconds, memory analysis, min-of-3 wall, and the chains of a seeded
  sample of problems compared with the host oracle solve_host;
- coverage / polya / bounds: the small device passes against their host
  twins at stage-realistic sizes;
- e2e: a simulated ~1M-read corpus through `python -m freddie_jax.cli
  pipeline` on the card, then again on the CPU backend; every split,
  segment and cluster TSV and the GTF must be byte-identical, and the GPU
  run's segment stage must have launched on the GPU.

--multi runs only the multi-card paths: the sharded DP over a 1-D loci
mesh of every visible card against one card, and the CLI segment stage
on the corpus with every card against one, byte-identical.

The parent process never imports JAX: each phase that uses the cards runs
in a child, one at a time, so one process holds the cards. Any mismatch
or failure exits non-zero before the last line, which is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# (B, P, R) of the DP phase: the bucket edges of ops.segdp.bucket_shape.
DP_SHAPES = ((2048, 64, 512), (512, 64, 1536), (2048, 32, 512), (2048, 16, 128))
MULTI_DP_SHAPE = (2048, 64, 512)
SAMPLE = 32  # problems per (shape, weights) compared with the host oracle
READ_SUPPORT = 3
# bench.SIM at 3,700 genes: ~999k reads over 3,700 loci.
E2E_GENES = 3700
CHILD_TIMEOUT_S = 1100


# ----------------------------------------------------------- generators


def _lower_edge(x: int, edges: tuple[int, ...]) -> int:
    return max([e for e in edges if e < x], default=0)


def make_problems(rng, B: int, P: int, R: int, wide: bool) -> list:
    """B DP problems that land in the (P, R) bucket: candidate and rep
    counts above the next-smaller bucket edges, so padding is exercised.
    Coverage follows a few true breakpoints (reps present or absent per
    segment, with noise), so most problems segment. Narrow weights are
    1..127; wide problems also carry heavy reps up to 16,383."""
    from freddie_jax.ops.segdp import P_EDGES, R_EDGES, DPProblem

    n_lo = max(_lower_edge(P, P_EDGES), 2) + 1
    r_lo = _lower_edge(R, R_EDGES) + 1
    problems = []
    for _ in range(B):
        n = int(rng.integers(n_lo, P + 1))
        r = int(rng.integers(r_lo, R + 1))
        gaps = rng.integers(1, 400, size=n - 1)
        y = np.concatenate([[0], np.cumsum(gaps)]).astype(np.int64)
        k = min(int(rng.integers(1, max(2, n // 4) + 1)), n - 2)
        cuts = np.sort(rng.choice(np.arange(1, n - 1), size=k, replace=False))
        seg = np.searchsorted(cuts, np.arange(n - 1), side="right")
        present = rng.random((k + 1, r)) < 0.5
        frac = np.where(present[seg], rng.uniform(0.9, 1.0, (n - 1, r)),
                        rng.uniform(0.0, 0.1, (n - 1, r)))
        inc = np.floor(frac * gaps[:, None]).astype(np.int64)
        C = np.concatenate([np.zeros((1, r), np.int64), np.cumsum(inc, axis=0)])
        W = rng.integers(1, 128, size=r).astype(np.int64)
        if wide:
            heavy = rng.random(r) < 0.05
            W[heavy] = rng.integers(128, 16384, size=int(heavy.sum()))
            W[int(rng.integers(r))] = 16383
        assert W.sum() < 2**24  # every score stays exact in f32
        problems.append(DPProblem(C=C, y=y, W=W, read_support=READ_SUPPORT))
    return problems


def pad_batch(problems: list, P: int, R: int):
    """Pad problems into one (B, P, R) batch by dispatch_batch_device's
    rules: y and C rows past a problem's candidates replicate its last
    one, padded reps weigh 0."""
    B = len(problems)
    C = np.zeros((B, P, R), np.int32)
    y = np.zeros((B, P), np.int32)
    W = np.zeros((B, R), np.float32)
    n_cand = np.zeros(B, np.int32)
    for b, pr in enumerate(problems):
        p, r = pr.C.shape
        C[b, :p, :r] = pr.C
        C[b, p:, :r] = pr.C[-1]
        y[b, :p] = pr.y
        y[b, p:] = pr.y[-1]
        W[b, :r] = pr.W
        n_cand[b] = p
    return C, y, W, n_cand


def decode_chains(chains: np.ndarray) -> list[list[int]]:
    from freddie_jax.ops.segdp import collect_batch_device

    n = len(chains)
    return collect_batch_device(chains, list(range(n)), [None] * n)


def host_chains(problems: list) -> list[list[int]]:
    from concurrent.futures import ThreadPoolExecutor

    from freddie_jax.ops.segdp import solve_host
    from freddie_jax.ops.thresholds import ScaledThresholds

    thr = ScaledThresholds(0.9)
    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(lambda pr: solve_host(pr, thr), problems))


# ------------------------------------------------------- device phases


def preflight(min_count: int = 1) -> dict:
    """Require GPUs from JAX; print the JAX version, the devices and the
    first device's memory limit; return the device record of the last
    line."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < min_count:
        raise RuntimeError(
            f"need {min_count} GPU(s); JAX found {devices} "
            f"(JAX_PLATFORMS={os.environ.get('JAX_PLATFORMS')!r})"
        )
    limit = (devices[0].memory_stats() or {}).get("bytes_limit")
    print(f"[preflight] jax {jax.__version__} devices={devices} "
          f"bytes_limit={limit}", flush=True)
    return dict(platform=devices[0].platform, kind=devices[0].device_kind,
                count=len(devices))


def _mib(n: int) -> str:
    return f"{n / 2**20:.1f}MiB"


def _check_highest(lowered) -> int:
    """Every dot of the lowered DP asks for HIGHEST precision."""
    dots = [l for l in lowered.as_text().splitlines() if "dot_general" in l]
    if not dots or not all("precision = [HIGHEST, HIGHEST]" in l for l in dots):
        raise AssertionError("a DP contraction is not at HIGHEST precision")
    return len(dots)


def _timed(fn, *args, **kw):
    out = fn(*args, **kw).block_until_ready()  # warm
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = fn(*args, **kw).block_until_ready()
        walls.append(time.perf_counter() - t0)
    return out, min(walls)


def _compare_sample(rng, problems, chains, tag) -> str:
    """Chains of a seeded sample against solve_host; raises on any
    difference, or when no sampled problem segmented."""
    idx = np.sort(rng.choice(len(problems), size=min(SAMPLE, len(problems)),
                             replace=False))
    got = decode_chains(np.asarray(chains)[idx])
    want = host_chains([problems[i] for i in idx])
    bad = [int(i) for i, g, w in zip(idx, got, want) if g != w]
    if bad:
        raise AssertionError(f"{tag}: problems {bad} differ from solve_host")
    if not any(want):
        raise AssertionError(f"{tag}: no sampled problem segmented")
    return (f"sample={len(idx)} identical_to_solve_host "
            f"segmented={sum(1 for w in want if w)}")


def dp_phase(shapes=DP_SHAPES, seed: int = 0) -> None:
    import jax
    import jax.numpy as jnp

    from freddie_jax.ops.segdp import _get_jitted
    from freddie_jax.ops.thresholds import ScaledThresholds

    thr = ScaledThresholds(0.9)
    lookup = jnp.asarray(thr.lookup)
    for B, P, R in shapes:
        compiled = None
        for wide in (False, True):
            rng = np.random.default_rng([seed, B, P, R, int(wide)])
            problems = make_problems(rng, B, P, R, wide)
            args = [jax.device_put(a) for a in pad_batch(problems, P, R)]
            if compiled is None:
                t0 = time.perf_counter()
                lowered = _get_jitted().lower(
                    *args, read_support=READ_SUPPORT, lookup=lookup,
                    scale=thr.scale)
                compiled = lowered.compile()
                compile_s = time.perf_counter() - t0
                n_dots = _check_highest(lowered)
                mem = compiled.memory_analysis()
            chains, wall = _timed(compiled, *args, lookup=lookup)
            tag = f"B={B} P={P} R={R} weights={'wide' if wide else 'narrow'}"
            checked = _compare_sample(rng, problems, chains, tag)
            print(
                f"[dp] {tag} max_w={int(args[2].max())} "
                f"compile_s={compile_s:.2f} wall_ms={wall * 1e3:.3f} "
                f"mem(arg={_mib(mem.argument_size_in_bytes)} "
                f"out={_mib(mem.output_size_in_bytes)} "
                f"temp={_mib(mem.temp_size_in_bytes)}) "
                f"precision=HIGHEST({n_dots} dots) {checked}",
                flush=True,
            )


def coverage_phase(seed: int = 1, B: int = 256, I: int = 2048, P: int = 64,
                   R: int = 512) -> None:
    """build_coverage_device against cumulative_coverage: every interval
    shipped, so the device C equals the host's rows exactly."""
    from freddie_jax.ops.coverage import build_coverage_device, cumulative_coverage

    rng = np.random.default_rng(seed)
    iv = np.zeros((B, I, 3), np.int32)
    y = np.sort(rng.integers(1, 20_000, size=(B, P)), axis=1).astype(np.int32)
    iv[:, :, 0] = rng.integers(0, 19_000, size=(B, I))
    iv[:, :, 1] = iv[:, :, 0] + rng.integers(0, 1_500, size=(B, I))
    iv[:, :, 2] = rng.integers(0, R, size=(B, I))
    t0 = time.perf_counter()
    got = np.asarray(build_coverage_device(iv, y, R))
    wall = time.perf_counter() - t0
    for b in range(B):
        want = cumulative_coverage(iv[b, :, 0], iv[b, :, 1], iv[b, :, 2], R,
                                   y[b].astype(np.int64))[:P]
        if not np.array_equal(got[b].astype(np.int64), want):
            raise AssertionError(f"coverage: problem {b} differs from the host")
    print(f"[coverage] B={B} I={I} P={P} R={R} first_call_s={wall:.2f} "
          f"identical_to_cumulative_coverage", flush=True)


def polya_phase(work: str, genes: int = 24) -> None:
    """annotate_gaps_and_polya_batch with the device route forced against
    the per-read host annotator, on every read of a simulated corpus."""
    from freddie_jax.config import SegmentConfig, SplitConfig
    from freddie_jax.io.tsv import load_read_sequences, parse_split_tsv
    from freddie_jax.ops import polya_batch
    from freddie_jax.ops.polya import annotate_gaps_and_polya
    from freddie_jax.ops.thresholds import ScaledThresholds
    from freddie_jax.stages.segment import genotype_tint, prepare_tint, solve_problems
    from freddie_jax.stages.split import run_split

    bam, fq = simulate_corpus(work, genes)
    split_dir = os.path.join(work, "split")
    counts = run_split(bam, [fq], split_dir, SplitConfig())
    cfg = SegmentConfig(use_device=False)
    thr = ScaledThresholds(cfg.threshold_rate)
    items, want = [], []
    for contig, n in counts.items():
        cdir = os.path.join(split_dir, contig)
        for t in range(n):
            tint = parse_split_tsv(os.path.join(cdir, f"split_{contig}_{t}.tsv"))
            load_read_sequences(tint, os.path.join(cdir, f"reads_{contig}_{t}.tsv"))
            work_t, problems = prepare_tint(tint, cfg, thr)
            _fp, segs = genotype_tint(work_t, solve_problems(problems, cfg, thr),
                                      cfg, thr)
            for read in tint.reads:
                it = (read.data, segs, read.intervals, read.seq, read.strand)
                items.append(it)
                want.append(annotate_gaps_and_polya(*it))
    os.environ["FREDDIE_POLYA_DEVICE"] = "1"
    try:
        t0 = time.perf_counter()
        got = polya_batch.annotate_gaps_and_polya_batch(items)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("FREDDIE_POLYA_DEVICE")
    if not polya_batch._jit_cache:
        raise AssertionError("polya: the device scan never ran")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"polya: reads {bad[:10]} differ from the host")
    n_tok = sum(1 for toks in got for tok in toks if tok[:2] in ("SA", "ST", "EA", "ET"))
    print(f"[polya] reads={len(items)} polya_tokens={n_tok} first_call_s={wall:.2f} "
          f"identical_to_annotate_gaps_and_polya", flush=True)


def bounds_phase(seed: int = 2, N: int = 1000, Mi: int = 24, K: int = 20_000,
                 sample: int = 16_384) -> None:
    """The cluster solver's device bounds against the numpy path: every
    mask of a wide instance (_optimistic_device, compared on a seeded
    sample) and an explicit closure-sized mask list
    (_optimistic_masks_device, compared on all of it)."""
    from freddie_jax.solver.exact import ClusterInstance, ReadRow
    from freddie_jax.solver.segenum import (
        _optimistic_device,
        _optimistic_masks_device,
        _PerStructure,
    )

    rng = np.random.default_rng(seed)
    trues = [rng.random(Mi) < 0.5 for _ in range(4)]
    rows = []
    for _ in range(N):
        exons = trues[int(rng.integers(len(trues)))].copy()
        corr = np.zeros(Mi, bool)
        drop = exons & (rng.random(Mi) < 0.08)
        exons[drop] = False
        corr[drop] = True
        rows.append(ReadRow(exons=exons, corr=corr,
                            garbage=1.5 * float(rng.integers(1, 7)), gaps=[]))
    inst = ClusterInstance(rows=rows, seg_len=rng.integers(50, 2000, size=Mi),
                           incomp=[], epsilon=0.2, offset=20)
    ctx = _PerStructure(inst)
    t0 = time.perf_counter()
    full = _optimistic_device(inst, 1 << Mi)
    wall_full = time.perf_counter() - t0
    picks = np.sort(rng.choice(1 << Mi, size=sample, replace=False)).astype(np.uint64)
    if not np.array_equal(full[picks.astype(np.int64)], ctx.optimistic_block(picks)):
        raise AssertionError("bounds: _optimistic_device differs from numpy")
    masks = np.unique(rng.integers(0, 1 << Mi, size=K)).astype(np.uint64)
    t0 = time.perf_counter()
    got = _optimistic_masks_device(ctx, masks)
    wall_masks = time.perf_counter() - t0
    if not np.array_equal(got, ctx.optimistic_block(masks)):
        raise AssertionError("bounds: _optimistic_masks_device differs from numpy")
    print(f"[bounds] N={N} Mi={Mi} all_masks={1 << Mi} sampled={sample} "
          f"first_call_s={wall_full:.2f} explicit_masks={len(masks)} "
          f"first_call_s={wall_masks:.2f} identical_to_optimistic_block",
          flush=True)


def multi_dp_phase(shape=MULTI_DP_SHAPE, seed: int = 3) -> None:
    """The sharded DP (solve_batch_sharded's jit over a loci mesh of every
    visible device) against the one-device production jit: identical
    chains on the whole batch, both timed."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from freddie_jax.ops.segdp import _get_jitted
    from freddie_jax.ops.thresholds import ScaledThresholds
    from freddie_jax.parallel.mesh import _sharded_solver, loci_mesh

    thr = ScaledThresholds(0.9)
    B, P, R = shape
    rng = np.random.default_rng(seed)
    problems = make_problems(rng, B, P, R, wide=True)
    host = pad_batch(problems, P, R)
    dev0 = jax.devices()[0]
    one_args = [jax.device_put(a, dev0) for a in host]
    lookup = jax.device_put(np.asarray(thr.lookup), dev0)
    one = _get_jitted().lower(*one_args, read_support=READ_SUPPORT,
                              lookup=lookup, scale=thr.scale).compile()
    chains1, wall1 = _timed(one, *one_args, lookup=lookup)

    mesh = loci_mesh(local=True)
    batch = NamedSharding(mesh, PartitionSpec("loci"))
    sh_args = [jax.device_put(a, batch) for a in host]
    sh_lookup = jax.device_put(np.asarray(thr.lookup),
                               NamedSharding(mesh, PartitionSpec()))
    sharded = _sharded_solver(mesh, READ_SUPPORT, thr.scale,
                              return_chains=True)
    t0 = time.perf_counter()
    compiled = sharded.lower(*sh_args, sh_lookup).compile()
    compile_s = time.perf_counter() - t0
    chainsN, wallN = _timed(compiled, *sh_args, sh_lookup)
    if not np.array_equal(np.asarray(chains1), np.asarray(chainsN)):
        raise AssertionError("multi dp: sharded chains differ from one device")
    checked = _compare_sample(rng, problems, chainsN, "multi dp")
    print(f"[multi-dp] B={B} P={P} R={R} weights=wide devices={mesh.size} "
          f"one_device_ms={wall1 * 1e3:.3f} sharded_ms={wallN * 1e3:.3f} "
          f"sharded_compile_s={compile_s:.2f} identical_to_one_device "
          f"{checked}",
          flush=True)


def run_phase(name: str) -> None:
    """Child side: the phases that hold the cards."""
    from freddie_jax.utils.procenv import use_compile_cache

    use_compile_cache()
    if name == "multi":
        device = preflight(min_count=2)
        multi_dp_phase()
    else:
        device = preflight()
        dp_phase()
        coverage_phase()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_polya_") as work:
            polya_phase(work)
        bounds_phase()
    print("[device] " + json.dumps(device), flush=True)


# ----------------------------------------------------- parent: e2e runs


def simulate_corpus(work: str, genes: int) -> tuple[str, str]:
    """bench.SIM at `genes` genes, written as BAM + FASTQ under work."""
    from bench import SIM
    from freddie_jax.utils.sim import simulate

    sim = simulate(**dict(SIM, n_genes=genes))
    bam, fq = os.path.join(work, "reads.bam"), os.path.join(work, "reads.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    return bam, fq


def count_reads(fq: str) -> int:
    with open(fq, "rb") as f:
        return sum(1 for _ in f) // 4


STAGE_RE = re.compile(
    r"^\[pipeline\] (\w+): done in ([\d.]+)s \(.*\) engine=(\w+)$")
DP_RE = re.compile(
    r"^\[segment\] engine=(\w+) dp launches=(\d+) host_problems=(\d+)"
    r"(?: peak_bytes=(\d+))?(?: devices=(\d+) backend=(\w+) device_kind=(.+))?$")


def parse_log(text: str) -> dict:
    """Stage walls and engines, and the segment stage's dp summary, from
    a pipeline or segment CLI run's stdout."""
    out: dict = {"stages": {}, "dp": None}
    for line in text.splitlines():
        m = STAGE_RE.match(line)
        if m:
            out["stages"][m[1]] = dict(seconds=float(m[2]), engine=m[3])
        m = DP_RE.match(line)
        if m:
            out["dp"] = dict(
                engine=m[1], launches=int(m[2]), host_problems=int(m[3]),
                peak_bytes=None if m[4] is None else int(m[4]),
                devices=None if m[5] is None else int(m[5]),
                backend=m[6], device_kind=m[7],
            )
    return out


def run_child(args: list[str], env: dict | None = None) -> str:
    """Run one child to its end; its stdout is returned, its stderr
    passes through. A failure or a timeout stops the smoke run."""
    full_env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    proc = subprocess.run(
        [sys.executable, *args], cwd=REPO, env=full_env, stdout=subprocess.PIPE,
        text=True, timeout=CHILD_TIMEOUT_S,
    )
    if proc.returncode != 0:
        sys.stdout.write(proc.stdout)
        raise SystemExit(f"child {args} failed with exit code {proc.returncode}")
    return proc.stdout


def output_files(root: str) -> list[str]:
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _dirs, files in os.walk(root)
        for f in files
        if f.endswith((".tsv", ".gtf"))
    )


def compare_outputs(a: str, b: str) -> int:
    """Byte-compare every TSV and GTF under two output trees; returns the
    number of files compared."""
    names = output_files(a)
    if names != output_files(b):
        raise AssertionError(f"{a} and {b} hold different output files")
    if not names:
        raise AssertionError(f"{a} holds no outputs")
    bad = [n for n in names
           if not filecmp.cmp(os.path.join(a, n), os.path.join(b, n), shallow=False)]
    if bad:
        raise AssertionError(f"{len(bad)} files differ, e.g. {bad[:5]}")
    return len(names)


def e2e(work: str, bam: str, fq: str, card: str) -> None:
    n_reads = count_reads(fq)
    runs = {}
    for backend, env in (("gpu", None), ("cpu", {"JAX_PLATFORMS": "cpu"})):
        out = os.path.join(work, f"out_{backend}")
        runs[backend] = parse_log(run_child(
            ["-m", "freddie_jax.cli", "pipeline", "-b", bam, "-r", fq, "-o", out],
            env))
    n_files = compare_outputs(os.path.join(work, "out_gpu"),
                              os.path.join(work, "out_cpu"))
    gpu = runs["gpu"]
    dp = gpu["dp"]
    if dp is None or dp["launches"] <= 0 or dp["backend"] != "gpu":
        raise AssertionError(f"e2e: the segment stage did not launch on the GPU: {dp}")
    if set(gpu["stages"]) != {"split", "segment", "cluster", "isoforms"}:
        raise AssertionError(f"e2e: stage log incomplete: {gpu['stages']}")

    def walls(run):
        return " ".join(f"{k}={v['seconds']:.2f}s({v['engine']})"
                        for k, v in run["stages"].items())

    total = sum(v["seconds"] for v in gpu["stages"].values())
    cpu_total = sum(v["seconds"] for v in runs["cpu"]["stages"].values())
    print(f"[e2e] card={card} reads={n_reads} gpu_run: {walls(gpu)} "
          f"total={total:.2f}s reads_per_s={n_reads / total:.0f} "
          f"dp_launches={dp['launches']} host_problems={dp['host_problems']} "
          f"peak_bytes_in_use={dp['peak_bytes']} device_kind={dp['device_kind']}; "
          f"cpu_backend_run: {walls(runs['cpu'])} total={cpu_total:.2f}s; "
          f"{n_files} files byte-identical", flush=True)


def e2e_multi(work: str, bam: str, fq: str, card: str) -> None:
    """The CLI segment stage with every visible card against one card."""
    split = os.path.join(work, "split")
    run_child(["-m", "freddie_jax.cli", "split", "-b", bam, "-r", fq,
               "-o", split], {"JAX_PLATFORMS": "cpu"})
    runs = {}
    for name, env in (("one", {"CUDA_VISIBLE_DEVICES": "0"}), ("all", None)):
        t0 = time.perf_counter()
        text = run_child(["-m", "freddie_jax.cli", "segment", "-s", split,
                          "-o", os.path.join(work, f"seg_{name}")], env)
        runs[name] = (parse_log(text)["dp"], time.perf_counter() - t0, text)
    n_files = compare_outputs(os.path.join(work, "seg_one"),
                              os.path.join(work, "seg_all"))
    parts = []
    for name, (dp, child_s, text) in runs.items():
        if dp is None or dp["launches"] <= 0 or dp["backend"] != "gpu":
            raise AssertionError(f"multi e2e: no GPU launches with {name}: {dp}")
        stage_s = re.search(r"tints in ([\d.]+)s", text)[1]
        parts.append(f"{dp['devices']}_devices: segment={stage_s}s "
                     f"child={child_s:.2f}s launches={dp['launches']}")
    if runs["all"][0]["devices"] < 2:
        raise AssertionError("multi e2e: only one device was visible")
    print(f"[multi-e2e] card={card} reads={count_reads(fq)} {'; '.join(parts)}; "
          f"{n_files} segment TSVs byte-identical", flush=True)


def nvidia_smi() -> str:
    """The cards' name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise SystemExit("nvidia-smi reported no GPU")
    return "; ".join(out.splitlines())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the multi-card paths (every visible card)")
    ap.add_argument("--phase", choices=("single", "multi"),
                    help=argparse.SUPPRESS)  # child side
    args = ap.parse_args(argv)
    if args.phase:
        run_phase(args.phase)
        return 0

    os.environ.setdefault("JAX_PLATFORMS", "cuda")
    if not args.multi:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    try:
        card = nvidia_smi()
    except (OSError, subprocess.CalledProcessError) as e:
        raise SystemExit(f"nvidia-smi failed: {e}")
    print(f"[card] {card}", flush=True)

    phase = "multi" if args.multi else "single"
    text = run_child([os.path.abspath(__file__), "--phase", phase])
    sys.stdout.write("".join(l + "\n" for l in text.splitlines()
                             if not l.startswith("[device] ")))
    device = json.loads(text.splitlines()[-1][len("[device] "):])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        t0 = time.perf_counter()
        bam, fq = simulate_corpus(work, E2E_GENES)
        print(f"[corpus] genes={E2E_GENES} reads={count_reads(fq)} "
              f"simulate_s={time.perf_counter() - t0:.1f}", flush=True)
        (e2e_multi if args.multi else e2e)(work, bam, fq, card)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
