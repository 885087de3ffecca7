"""Native segment host engine (native/segcore.cpp): whole-stage outputs
must be byte-identical to the Python oracle path, and per-call results
(load/coverage/finalize) must match their Python counterparts exactly."""

import filecmp
import os

import numpy as np
import pytest

from freddie_jax.config import SegmentConfig, SplitConfig
from freddie_jax.ops.segcore import load_segcore
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate

eng = load_segcore()
pytestmark = pytest.mark.skipif(eng is None, reason="segcore did not build")


@pytest.fixture(scope="module", params=[31, 77])
def split_dir(tmp_path_factory, request):
    d = tmp_path_factory.mktemp(f"segcore{request.param}")
    sim = simulate(seed=request.param)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(d / "split")
    run_split(bam, [fq], out, SplitConfig())
    return out


def _tsv_set(outdir):
    files = []
    for root, _dirs, fns in os.walk(outdir):
        for fn in sorted(fns):
            files.append(os.path.join(root, fn))
    return sorted(files)


@pytest.mark.parametrize("consider_ends", [False, True])
def test_stage_byte_identical(split_dir, tmp_path, monkeypatch, consider_ends):
    """run_segment with the native engine == run_segment on the Python
    path, byte for byte, across every tint TSV (both consider_ends)."""
    from freddie_jax.stages import segment as seg

    cfg = SegmentConfig(consider_ends=consider_ends)
    py_out = str(tmp_path / "py")
    nat_out = str(tmp_path / "nat")
    monkeypatch.setenv("FREDDIE_SEGCORE", "0")
    seg.run_segment(split_dir, py_out, cfg)
    monkeypatch.delenv("FREDDIE_SEGCORE")
    seg.run_segment(split_dir, nat_out, cfg)
    py_files = _tsv_set(py_out)
    nat_files = _tsv_set(nat_out)
    assert [os.path.relpath(f, py_out) for f in py_files] == [
        os.path.relpath(f, nat_out) for f in nat_files
    ]
    assert py_files
    for a, b in zip(py_files, nat_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, py_out)


def test_load_matches_python_parse(split_dir):
    """segcore.load's tint metadata, weights and splice signal equal the
    Python parser + build_splice_signal exactly."""
    from freddie_jax.io.tsv import load_read_sequences, parse_split_tsv
    from freddie_jax.stages.segment import build_splice_signal

    checked = 0
    for contig in sorted(os.listdir(split_dir)):
        cdir = os.path.join(split_dir, contig)
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if not (fn.startswith("split_") and fn.endswith(".tsv")):
                continue
            tid = int(fn[:-4].split("_")[-1])
            split_tsv = os.path.join(cdir, fn)
            reads_tsv = os.path.join(cdir, f"reads_{contig}_{tid}.tsv")
            for consider_ends in (False, True):
                caps, chrom, tint_id, ivs, n_reads, n_reps, w_b, y_b = eng.load(
                    split_tsv, reads_tsv, int(consider_ends)
                )
                tint = parse_split_tsv(split_tsv)
                load_read_sequences(tint, reads_tsv)
                assert chrom == tint.chrom
                assert tint_id == tint.id
                assert ivs == list(tint.intervals)
                assert n_reads == len(tint.reads)
                assert n_reps == len(tint.read_reps)
                w = np.frombuffer(w_b, dtype=np.int64)
                assert w.tolist() == [len(r) for _, r in tint.read_reps]
                y_raws, per_iv = build_splice_signal(tint, consider_ends)
                assert len(y_b) == len(y_raws)
                for got_b, want in zip(y_b, y_raws):
                    got = np.frombuffer(got_b, dtype=np.float64)
                    assert np.array_equal(got, want)
                # Coverage at a few candidate sets vs the Python op.
                from freddie_jax.ops.coverage import cumulative_coverage

                for iv_idx, rows in enumerate(per_iv):
                    n_y = len(y_raws[iv_idx])
                    cands = sorted({0, n_y // 3, (2 * n_y) // 3, n_y - 1})
                    buf = eng.coverage(caps, iv_idx, cands)
                    got = np.frombuffer(buf, dtype=np.int64).reshape(
                        len(cands) + 1, n_reps
                    )
                    if rows is None:
                        s = e = r = np.zeros(0, dtype=np.int64)
                    else:
                        s, e, r = rows
                    want = cumulative_coverage(
                        s, e, r, n_reps, np.array(cands), validate=True
                    )
                    assert np.array_equal(got, np.asarray(want, dtype=np.int64))
            checked += 1
    assert checked > 0


def test_finalize_error_falls_back(split_dir, tmp_path, monkeypatch):
    """A C-side failure in finalize degrades to the Python path for that
    tint; the stage still writes byte-identical output."""
    from freddie_jax.stages import segment as seg

    cfg = SegmentConfig()
    py_out = str(tmp_path / "py")
    monkeypatch.setenv("FREDDIE_SEGCORE", "0")
    seg.run_segment(split_dir, py_out, cfg)
    monkeypatch.delenv("FREDDIE_SEGCORE")

    broken = str(tmp_path / "broken")
    orig = seg.finalize_tint_native

    def explode(*a, **k):
        raise AssertionError("forced native-finalize failure")

    monkeypatch.setattr(seg, "finalize_tint_native", explode)
    seg.run_segment(split_dir, broken, cfg)
    monkeypatch.setattr(seg, "finalize_tint_native", orig)
    py_files = _tsv_set(py_out)
    broken_files = _tsv_set(broken)
    assert [os.path.relpath(f, py_out) for f in py_files] == [
        os.path.relpath(f, broken) for f in broken_files
    ]
    for a, b in zip(py_files, broken_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, py_out)
