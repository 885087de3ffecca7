"""Batched polyA scorer vs the host implementation, window by window."""

import numpy as np

from freddie_jax.ops.polya import longest_poly_runs
from freddie_jax.ops.polya_batch import best_poly_batch


def host_best(window: str, char: str):
    cands = []
    for f, l, p in longest_poly_runs(window, 0, len(window), 1, char):
        if l < 20 or p < 0.85:
            continue
        cands.append((f, l, p))
    if not cands:
        return None
    best = max(cands, key=lambda t: t[2])  # first-wins ties (list order)
    f, l, p = best
    return (f, l, round(p * l))


def random_window(rng, n, polya_prob):
    chars = []
    i = 0
    while i < n:
        if rng.random() < polya_prob:
            run = int(rng.integers(15, 60))
            for _ in range(run):
                chars.append("A" if rng.random() > 0.1 else rng.choice(list("CGT")))
            i += run
        else:
            chars.append(rng.choice(list("ACGT")))
            i += 1
    return "".join(chars[:n])


def test_matches_host_random():
    rng = np.random.default_rng(0)
    windows, chars = [], []
    for _ in range(60):
        n = int(rng.integers(0, 400))
        windows.append(random_window(rng, n, polya_prob=0.15))
        chars.append(rng.choice(["A", "T"]))
    got = best_poly_batch(windows, chars)
    want = [host_best(w, c) for w, c in zip(windows, chars)]
    assert got == want


def test_edge_cases():
    # pure polyA, exactly-threshold purity, too-short runs
    windows = [
        "A" * 30,                     # perfect run
        "A" * 17 + "C" + "A" * 2,     # 20 long, purity 19/20 = 0.95
        "A" * 19,                     # too short
        "",                           # empty
        "C" * 100,                    # no run
        ("A" * 20 + "C" * 5) * 4,     # multiple runs
    ]
    chars = ["A"] * len(windows)
    got = best_poly_batch(windows, chars)
    want = [host_best(w, c) for w, c in zip(windows, chars)]
    assert got == want


def test_long_window_fallback():
    rng = np.random.default_rng(5)
    w = random_window(rng, 3000, polya_prob=0.1)
    got = best_poly_batch([w], ["A"])
    assert got == [host_best(w, "A")]


def test_annotate_batch_matches_host_per_read():
    """annotate_gaps_and_polya_batch == annotate_gaps_and_polya on
    simulated tints (both strands, noisy soft clips)."""
    from freddie_jax.config import SegmentConfig, SplitConfig
    from freddie_jax.ops.polya import annotate_gaps_and_polya
    from freddie_jax.ops.polya_batch import annotate_gaps_and_polya_batch
    from freddie_jax.ops.segdp import DPProblem  # noqa: F401 (import check)
    from freddie_jax.ops.thresholds import ScaledThresholds
    from freddie_jax.stages.segment import genotype_tint, prepare_tint, solve_problems
    from freddie_jax.io.tsv import parse_split_tsv, load_read_sequences
    from freddie_jax.stages.split import run_split
    from freddie_jax.utils.sim import simulate
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        sim = simulate(seed=23)
        bam, fq = os.path.join(d, "r.bam"), os.path.join(d, "r.fastq")
        sim.write_bam(bam)
        sim.write_fastq(fq)
        split_dir = os.path.join(d, "split")
        counts = run_split(bam, [fq], split_dir, SplitConfig())
        cfg = SegmentConfig()
        thr = ScaledThresholds(cfg.threshold_rate)
        items, want = [], []
        for contig, n in counts.items():
            for t in range(n):
                cdir = os.path.join(split_dir, contig)
                tint = parse_split_tsv(os.path.join(cdir, f"split_{contig}_{t}.tsv"))
                load_read_sequences(tint, os.path.join(cdir, f"reads_{contig}_{t}.tsv"))
                work, problems = prepare_tint(tint, cfg, thr)
                sols = solve_problems(problems, cfg, thr)
                _fp, segs = genotype_tint(work, sols, cfg, thr)
                for read in tint.reads:
                    items.append((read.data, segs, read.intervals, read.seq, read.strand))
                    want.append(
                        annotate_gaps_and_polya(
                            read.data, segs, read.intervals, read.seq, read.strand
                        )
                    )
        assert len(items) > 30
        got = annotate_gaps_and_polya_batch(items)
        assert got == want
        # at least one read actually carries a polyA token on each side key
        joined = {tok[0] for toks in got for tok in toks if tok[:2] in ("SA", "ST", "EA", "ET")}
        assert joined, "simulation produced no polyA tails; test is vacuous"


def test_short_window_numpy_twin_fuzz():
    """Short windows route through the closed-form numpy scan on the CPU
    backend; pin it to the per-window host scorer across lengths 1..256,
    purities and both chars (the same distribution the device fuzz uses)."""
    rng = np.random.default_rng(17)
    windows, chars = [], []
    for _ in range(400):
        n = int(rng.integers(1, 257))
        windows.append(random_window(rng, n, polya_prob=float(rng.uniform(0, 0.35))))
        chars.append(rng.choice(["A", "T"]))
    got = best_poly_batch(windows, chars)
    want = [host_best(w, c) for w, c in zip(windows, chars)]
    assert got == want


def test_forced_device_path_matches(monkeypatch):
    """FREDDIE_POLYA_DEVICE=1 forces the jitted packed scan even on the
    CPU backend; its results must equal the numpy-twin routing."""
    monkeypatch.setenv("FREDDIE_POLYA_DEVICE", "1")
    rng = np.random.default_rng(29)
    windows, chars = [], []
    for _ in range(80):
        n = int(rng.integers(0, 300))
        windows.append(random_window(rng, n, polya_prob=0.2))
        chars.append(rng.choice(["A", "T"]))
    got_dev = best_poly_batch(windows, chars)
    monkeypatch.delenv("FREDDIE_POLYA_DEVICE")
    got_host = best_poly_batch(windows, chars)
    want = [host_best(w, c) for w, c in zip(windows, chars)]
    assert got_dev == want
    assert got_host == want


def test_long_window_vectorized_fallback_fuzz():
    """The numpy column-sweep twin (_scan_np) handles every window above
    MAX_WINDOW; pin it to the per-window host scorer across many lengths,
    purities and both scan chars (incl. rows chunked past one batch)."""
    from freddie_jax.ops.polya_batch import MAX_WINDOW

    rng = np.random.default_rng(11)
    windows, chars = [], []
    for _ in range(250):
        n = int(rng.integers(MAX_WINDOW + 1, 2200))
        windows.append(random_window(rng, n, polya_prob=float(rng.uniform(0, 0.3))))
        chars.append(rng.choice(["A", "T"]))
    got = best_poly_batch(windows, chars)
    want = [host_best(w, c) for w, c in zip(windows, chars)]
    assert got == want
