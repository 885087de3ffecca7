"""C clip-context/token twins (native/polyatok.c) vs the Python oracles:
identical results read-for-read on simulated data and on synthetic edge
cases (multi-run reads, slack gaps, insertion-clamp quirk)."""

import pytest

from freddie_jax.ops.polya import (
    _clip_context_py,
    _emit_tokens_py,
    _load_ctok,
    clip_context,
    emit_tokens,
)

pytestmark = pytest.mark.skipif(
    _load_ctok() is None, reason="no C toolchain available"
)


def test_simulated_reads_identical(tmp_path):
    import os

    import jax

    jax.config.update("jax_platforms", "cpu")
    from freddie_jax.config import SegmentConfig, SplitConfig
    from freddie_jax.io.tsv import load_read_sequences, parse_split_tsv
    from freddie_jax.ops.thresholds import ScaledThresholds
    from freddie_jax.stages.segment import (
        genotype_tint,
        prepare_tint,
        solve_problems,
    )
    from freddie_jax.stages.split import run_split
    from freddie_jax.utils.sim import simulate

    sim = simulate(seed=61, n_genes=3, isoforms_per_gene=2,
                   reads_per_isoform=30, indel_rate=0.12, end_jitter=20,
                   big_del_rate=0.1, tail_prob=0.8)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split_dir = str(tmp_path / "split")
    counts = run_split(bam, [fq], split_dir, SplitConfig())
    cfg = SegmentConfig()
    thr = ScaledThresholds(cfg.threshold_rate)
    n_checked = 0
    n_multi_run = 0
    for contig, n in counts.items():
        for t in range(n):
            cdir = os.path.join(split_dir, contig)
            tint = parse_split_tsv(os.path.join(cdir, f"split_{contig}_{t}.tsv"))
            load_read_sequences(tint, os.path.join(cdir, f"reads_{contig}_{t}.tsv"))
            work, problems = prepare_tint(tint, cfg, thr)
            sols = solve_problems(problems, cfg, thr)
            _fp, segs = genotype_tint(work, sols, cfg, thr)
            for read in tint.reads:
                got = clip_context(read.data, segs, read.intervals, read.seq)
                want = _clip_context_py(read.data, segs, read.intervals, read.seq)
                assert got == want
                if want is None:
                    continue
                q_ssc, q_esc, runs = want
                if len(runs) > 1:
                    n_multi_run += 1
                for best_s in (None, (2, 25, "A")):
                    for best_e in (None, (1, 30, "T")):
                        try:
                            w = _emit_tokens_py(q_ssc, q_esc, runs, best_s,
                                                best_e, segs, read.intervals,
                                                len(read.seq))
                        except AssertionError:
                            # synthetic candidate violates a gap bound for
                            # this read; both twins must reject (C first,
                            # falls back to Python, still raises)
                            with pytest.raises(AssertionError):
                                emit_tokens(q_ssc, q_esc, runs, best_s, best_e,
                                            segs, read.intervals, len(read.seq))
                            continue
                        g = emit_tokens(q_ssc, q_esc, runs, best_s, best_e,
                                        segs, read.intervals, len(read.seq))
                        assert g == w
                        n_checked += 1
    assert n_checked > 100
    assert n_multi_run > 0, "no multi-run reads; gap tokens untested"


def test_insertion_clamp_quirk():
    """walk_cigar_to clamps every op (including insertions) by the
    remaining target distance -- the C twin must reproduce the resulting
    query positions exactly."""
    from freddie_jax.io.bam import CIGAR_OP_CODE as OP

    # interval: target 100..120, query 0..30, cigar 10M 10I 10M
    cigar = [(OP["M"], 10), (OP["I"], 10), (OP["M"], 10)]
    intervals = [(100, 120, 0, 30, cigar)]
    segs = [(100, 105), (106, 112), (113, 120)]
    data = [1, 0, 1]
    got = clip_context(data, segs, intervals, "N" * 40)
    want = _clip_context_py(data, segs, intervals, "N" * 40)
    assert got == want
    q_ssc, q_esc, runs = want
    g = emit_tokens(q_ssc, q_esc, runs, None, None, segs, intervals, 40)
    w = _emit_tokens_py(q_ssc, q_esc, runs, None, None, segs, intervals, 40)
    assert g == w


def test_no_coverage_returns_none():
    assert clip_context([0, 0, 2], [(0, 1), (2, 3), (4, 5)], [], "NNNN") is None


def test_best_run_fuzz_vs_python_oracle():
    """C Kadane scorer (best_run) vs the Python _best_poly oracle across
    random sequences, windows, strands, and A/T densities -- including
    boundary purities around 0.85 (the 20*cnt >= 17*len integer filter
    must equal the float compare)."""
    import numpy as np

    from freddie_jax.ops.polya import _best_poly, _best_poly_py, _load_ctok

    mod = _load_ctok()
    if mod is None or not hasattr(mod, "best_run"):
        import pytest

        pytest.skip("no C toolchain")
    rng = np.random.default_rng(99)
    bases = np.array(list("ACGT"))
    for trial in range(400):
        L = int(rng.integers(1, 200))
        # Bias towards A/T-rich sequences so qualifying runs exist often.
        probs = rng.dirichlet([3, 1, 1, 3])
        seq = "".join(rng.choice(bases, size=L, p=probs))
        lo = int(rng.integers(0, L + 1))
        hi = int(rng.integers(lo, L + 1))
        strand = "+" if rng.random() < 0.5 else "-"
        got = _best_poly(seq, lo, hi, strand)
        want = _best_poly_py(seq, lo, hi, strand)
        assert got == want, (seq, lo, hi, strand, got, want)
