"""Native C++ BAM decoder vs the pure-Python reader: identical records."""

import pytest

from freddie_jax.io.bam import BamReader
from freddie_jax.io.bam_native import NativeBamReader, native_bam_available
from freddie_jax.utils.sim import simulate

pytestmark = pytest.mark.skipif(
    not native_bam_available(), reason="no C++ toolchain available"
)


def test_native_matches_python(tmp_path):
    sim = simulate(seed=8, n_genes=2, isoforms_per_gene=2, reads_per_isoform=7,
                   minus_strand_genes=True, truncate_prob=0.2)
    bam = str(tmp_path / "t.bam")
    sim.write_bam(bam)
    with BamReader(bam) as r:
        py = list(r)
        refs_py = (r.references, r.lengths)
    with NativeBamReader(bam) as r:
        nat = list(r)
        refs_nat = (r.references, r.lengths)
    assert refs_py == refs_nat
    assert len(py) == len(nat) == len(sim.reads)
    for a, b in zip(py, nat):
        assert a.query_name == b.query_name
        assert a.flag == b.flag
        assert a.reference_start == b.reference_start
        assert a.cigartuples == b.cigartuples
        assert a.query_sequence == b.query_sequence
        assert a.reference_name == b.reference_name
        assert a.mapq == b.mapq


def test_native_rejects_garbage(tmp_path):
    bad = tmp_path / "bad.bam"
    bad.write_bytes(b"not a bam file at all")
    with pytest.raises(ValueError):
        NativeBamReader(str(bad))


def test_interval_batch_matches_python_walk(tmp_path):
    """bamdec_next_batch_iv's CIGAR walk == core.cigar.alignment_intervals
    (values and rendered cigar strings), including D>20 -> N rewrites and
    the empty-interval filter."""
    from freddie_jax.core.cigar import alignment_intervals, cigar_to_str
    from freddie_jax.io.bam_native import iter_interval_records

    sim = simulate(seed=12, n_genes=2, isoforms_per_gene=3, reads_per_isoform=9,
                   minus_strand_genes=True, truncate_prob=0.3)
    bam = str(tmp_path / "t.bam")
    sim.write_bam(bam)
    with BamReader(bam) as r:
        py = list(r)
    with NativeBamReader(bam) as r:
        nat = list(iter_interval_records(r, max_del_size=20))
    assert len(py) == len(nat)
    n_iv = 0
    for a, b in zip(py, nat):
        assert a.query_name == b.query_name
        assert a.flag == b.flag
        assert a.reference_name == b.reference_name
        if a.is_unmapped or a.is_secondary or a.is_supplementary:
            assert b.intervals == []
            continue
        want = [
            (ts, te, qs, qe, cigar_to_str(cig))
            for ts, te, qs, qe, cig in alignment_intervals(
                a.cigartuples, a.reference_start, len(a.query_sequence), 20
            )
            if ts != te and qs != qe
        ]
        assert b.intervals == want, a.query_name
        n_iv += len(want)
    assert n_iv > len(py)  # spliced reads -> multiple intervals each


def test_split_native_ingest_byte_identical(tmp_path, monkeypatch):
    """run_split through the array-native ingest == run_split through the
    Python BamReader fallback, byte for byte, with and without the
    prefetch thread. (Engine pinned to the Python stage: the C++ split
    core has its own parity suite in test_native_split.py.)"""
    import filecmp
    import os

    from freddie_jax.config import SplitConfig
    from freddie_jax.io import bam_native
    from freddie_jax.stages.split import run_split

    monkeypatch.setenv("FREDDIE_SPLIT_ENGINE", "python")
    sim = simulate(seed=17)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)

    out_native = str(tmp_path / "native")
    counts_native = run_split(bam, [fq], out_native, SplitConfig())
    out_threads = str(tmp_path / "threads")
    counts_threads = run_split(bam, [fq], out_threads, SplitConfig(threads=2))

    real_open = bam_native.open_bam
    try:
        bam_native.open_bam = lambda path: BamReader(path)
        out_py = str(tmp_path / "py")
        counts_py = run_split(bam, [fq], out_py, SplitConfig())
    finally:
        bam_native.open_bam = real_open
    assert counts_native == counts_py == counts_threads

    def walk(root):
        out = []
        for r, _d, fns in os.walk(root):
            for fn in sorted(fns):
                out.append(os.path.relpath(os.path.join(r, fn), root))
        return sorted(out)

    files = walk(out_native)
    assert files == walk(out_py) == walk(out_threads) and files
    for rel in files:
        assert filecmp.cmp(
            os.path.join(out_native, rel), os.path.join(out_py, rel), shallow=False
        ), rel
        assert filecmp.cmp(
            os.path.join(out_native, rel), os.path.join(out_threads, rel), shallow=False
        ), rel


def test_prefetch_on_off_identical(tmp_path, monkeypatch):
    """The background BGZF prefetch thread (bam_io.h start_prefetch) must
    produce the exact record stream of the sequential path -- blocks are
    strictly ordered through a single producer, so any divergence is a
    pipeline bug."""
    sim = simulate(seed=31, n_genes=3, isoforms_per_gene=2,
                   reads_per_isoform=9, truncate_prob=0.1, indel_rate=0.05)
    bam = str(tmp_path / "t.bam")
    sim.write_bam(bam)

    def records():
        with NativeBamReader(bam) as r:
            return [(x.query_name, x.flag, x.reference_start,
                     tuple(x.cigartuples), x.query_sequence) for x in r]

    monkeypatch.setenv("FREDDIE_BGZF_PREFETCH", "0")
    seq = records()
    monkeypatch.delenv("FREDDIE_BGZF_PREFETCH")
    pre = records()
    assert seq == pre
    assert len(seq) == len(sim.reads)
