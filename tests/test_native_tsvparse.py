"""C split-TSV parser (native/tsvparse.c) vs the Python oracle:
object-for-object identical parses, identical rejection of malformed
files (the wrapper falls back to Python on any C-side exception, so
acceptance never depends on the toolchain)."""

import pytest

from freddie_jax.io.tsv import (
    _load_tsvparse,
    _parse_split_tsv_py,
    parse_split_tsv,
)

pytestmark = pytest.mark.skipif(
    _load_tsvparse() is None, reason="no C toolchain available"
)


def make_split(tmp_path, text):
    p = tmp_path / "split_chr1_1.tsv"
    p.write_text(text)
    return str(p)


GOOD = (
    "#chr1\t1\t100-200,300-400\t3\n"
    "0\tread_a\tchr1\t+\t1\t100-200:0-100:100M\n"
    "1\tread_b\tchr1\t-\t1\t100-150:0-50:25M5D25M\t300-400:50-150:60M40=\n"
    "2\tread_c soft\tchr1\t+\t1\t120-200:10-90:80M\n"
)


def assert_same(a, b):
    assert (a.id, a.chrom, a.intervals, a.read_count) == (
        b.id, b.chrom, b.intervals, b.read_count
    )
    assert len(a.reads) == len(b.reads)
    for ra, rb in zip(a.reads, b.reads):
        assert (ra.id, ra.name, ra.chrom, ra.strand, ra.tint) == (
            rb.id, rb.name, rb.chrom, rb.strand, rb.tint
        )
        assert ra.intervals == rb.intervals
    assert a.read_reps == b.read_reps


def test_equal_on_basic(tmp_path):
    p = make_split(tmp_path, GOOD)
    assert_same(parse_split_tsv(p), _parse_split_tsv_py(p))


def test_equal_on_simulated(tmp_path):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from freddie_jax.config import SplitConfig
    from freddie_jax.stages.split import run_split
    from freddie_jax.utils.sim import simulate

    sim = simulate(seed=303, n_genes=3, isoforms_per_gene=2,
                   reads_per_isoform=25, indel_rate=0.1, end_jitter=15)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    run_split(bam, [fq], str(tmp_path / "split"), SplitConfig())
    import glob

    files = sorted(glob.glob(str(tmp_path / "split" / "*" / "split_*.tsv")))
    assert files
    for f in files:
        assert_same(parse_split_tsv(f), _parse_split_tsv_py(f))


def test_segment_parser_equal_on_simulated(tmp_path):
    """C parse_segment_file == the Python segment parser object-for-object
    (incl. rep grouping) on noisy simulated segment TSVs with gaps,
    soft clips and polyA tails."""
    import glob

    import jax

    jax.config.update("jax_platforms", "cpu")
    from freddie_jax.config import SegmentConfig, SplitConfig
    from freddie_jax.io.tsv import _parse_segment_tsv_py, parse_segment_tsv
    from freddie_jax.stages.segment import run_segment
    from freddie_jax.stages.split import run_split
    from freddie_jax.utils.sim import simulate

    sim = simulate(seed=404, n_genes=4, isoforms_per_gene=2,
                   reads_per_isoform=30, indel_rate=0.1, end_jitter=20,
                   big_del_rate=0.1, tail_prob=0.8, truncate_prob=0.3)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    run_split(bam, [fq], str(tmp_path / "split"), SplitConfig())
    run_segment(str(tmp_path / "split"), str(tmp_path / "seg"), SegmentConfig())
    files = sorted(glob.glob(str(tmp_path / "seg" / "*" / "segment_*.tsv")))
    assert files
    n_tokens = 0
    for fpath in files:
        a, b = parse_segment_tsv(fpath), _parse_segment_tsv_py(fpath)
        assert (a.id, a.chrom, a.positions, a.segs) == (
            b.id, b.chrom, b.positions, b.segs
        )
        assert len(a.reads) == len(b.reads)
        for ra, rb in zip(a.reads, b.reads):
            assert (ra.id, ra.name, ra.chrom, ra.strand, ra.tint) == (
                rb.id, rb.name, rb.chrom, rb.strand, rb.tint
            )
            assert ra.data == rb.data
            assert ra.gaps == rb.gaps
            assert ra.softclip == rb.softclip
            assert ra.poly_tail == rb.poly_tail
            n_tokens += len(ra.gaps) + len(ra.softclip) + len(ra.poly_tail)
        assert a.read_reps == b.read_reps
    assert n_tokens > 100, "too few gap/tail tokens; test is vacuous"


def test_segment_parser_malformed_falls_back(tmp_path):
    """A gaps field the regex parser would scan permissively makes the C
    parser raise; the wrapper must return the Python parser's result."""
    from freddie_jax.io.tsv import _parse_segment_tsv_py, parse_segment_tsv

    text = (
        "#chr1\t1\t100,200,300\t\n"
        "0\tr0\tchr1\t+\t1\t10\tjunkSSC:5,1-1x:3,\n"
    )
    p = tmp_path / "segment_chr1_1.tsv"
    p.write_text(text)
    a, b = parse_segment_tsv(str(p)), _parse_segment_tsv_py(str(p))
    assert a.read_reps == b.read_reps
    assert a.reads[0].softclip == b.reads[0].softclip
    assert a.reads[0].gaps == b.reads[0].gaps


def test_split_parser_mutation_fuzz(tmp_path):
    """Random single-edit corruptions of a valid split TSV: the C-backed
    wrapper must agree with the Python oracle on every file -- same
    parse (object equality) or same rejection (both raise). Catches any
    case where the C parser would silently ACCEPT with different
    results."""
    import numpy as np

    from freddie_jax.io.tsv import _parse_split_tsv_py, parse_split_tsv

    rng = np.random.default_rng(99)
    base = GOOD
    alphabet = list("0123456789\t:,-MID=XN#+.chr_ab ")
    for trial in range(300):
        text = list(base)
        n_edits = int(rng.integers(1, 4))
        for _ in range(n_edits):
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, len(text)))
            if op == 0 and text:
                text[pos] = str(rng.choice(alphabet))
            elif op == 1:
                text.insert(pos, str(rng.choice(alphabet)))
            elif op == 2 and len(text) > 1:
                del text[pos]
        mutated = "".join(text)
        p = tmp_path / f"split_chr1_{trial}.tsv"
        p.write_text(mutated)
        try:
            want = _parse_split_tsv_py(str(p))
            want_err = None
        except Exception as e:
            want, want_err = None, type(e)
        try:
            got = parse_split_tsv(str(p))
            got_err = None
        except Exception as e:
            got, got_err = None, type(e)
        if want_err is not None:
            assert got_err is not None, f"trial {trial}: C accepted, Python rejected:\n{mutated!r}"
        else:
            assert got_err is None, f"trial {trial}: C rejected, Python accepted:\n{mutated!r}"
            assert_same(got, want)


def test_segment_parser_mutation_fuzz(tmp_path):
    """Same single-edit fuzz for the segment-TSV parser."""
    import numpy as np

    from freddie_jax.io.tsv import _parse_segment_tsv_py, parse_segment_tsv

    base = (
        "#chr1\t3\t100,200,350,500\n"
        "0\tread_a\tchr1\t+\t3\t110\tSSC:4,ESC:9,\n"
        "1\tread_b\tchr1\t-\t3\t012\t0-2:44,SA_25:3,SSC:1,ESC:0,\n"
        "2\tread_c\tchr1\t+\t3\t120\tEA_30:12,SSC:0,ESC:2,1-2:15,\n"
    )
    rng = np.random.default_rng(123)
    alphabet = list("0123456789\t:,-_ESCAT#+.chr ab")
    for trial in range(300):
        text = list(base)
        for _ in range(int(rng.integers(1, 4))):
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, len(text)))
            if op == 0 and text:
                text[pos] = str(rng.choice(alphabet))
            elif op == 1:
                text.insert(pos, str(rng.choice(alphabet)))
            elif op == 2 and len(text) > 1:
                del text[pos]
        mutated = "".join(text)
        p = tmp_path / f"segment_chr1_{trial}.tsv"
        p.write_text(mutated)
        try:
            want = _parse_segment_tsv_py(str(p))
            want_err = None
        except Exception as e:
            want, want_err = None, type(e)
        try:
            got = parse_segment_tsv(str(p))
            got_err = None
        except Exception as e:
            got, got_err = None, type(e)
        if want_err is not None:
            assert got_err is not None, f"trial {trial}: C accepted, Python rejected:\n{mutated!r}"
        else:
            assert got_err is None, f"trial {trial}: C rejected, Python accepted:\n{mutated!r}"
            assert (got.id, got.chrom, got.positions, got.segs) == (
                want.id, want.chrom, want.positions, want.segs
            )
            for ra, rb in zip(got.reads, want.reads):
                assert (ra.id, ra.name, ra.chrom, ra.strand, ra.tint,
                        ra.data, ra.gaps, ra.softclip, ra.poly_tail) == (
                    rb.id, rb.name, rb.chrom, rb.strand, rb.tint,
                    rb.data, rb.gaps, rb.softclip, rb.poly_tail
                )
            assert got.read_reps == want.read_reps


@pytest.mark.parametrize(
    "mutation",
    [
        # unsorted tint intervals (assert in both)
        GOOD.replace("100-200,300-400", "300-400,100-200"),
        # empty interval (ts >= te)
        GOOD.replace("120-200:10-90:80M", "200-120:10-90:80M"),
        # second header
        GOOD + "#chr1\t2\t500-600\t1\n",
        # bad read count type
        GOOD.replace("\t3\n", "\tx\n", 1),
    ],
)
def test_malformed_rejected_identically(tmp_path, mutation):
    p = make_split(tmp_path, mutation)
    with pytest.raises((AssertionError, ValueError)):
        _parse_split_tsv_py(p)
    with pytest.raises((AssertionError, ValueError)):
        parse_split_tsv(p)  # C first, falls back to Python, still raises
