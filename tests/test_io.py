"""I/O layer tests: BGZF/BAM roundtrip, FASTX parsing."""

import os
import random

from freddie_jax.io.bam import (
    BamReader,
    BamRecord,
    BamWriter,
    CMATCH,
    CREF_SKIP,
    CSOFT_CLIP,
    FLAG_REVERSE,
)
from freddie_jax.io.bgzf import BgzfReader, BgzfWriter
from freddie_jax.io.fastx import read_fastx, write_fastq


def test_bgzf_roundtrip(tmp_path):
    data = random.Random(0).randbytes(300_000)
    p = tmp_path / "x.bgzf"
    with open(p, "wb") as f:
        w = BgzfWriter(f)
        for i in range(0, len(data), 7001):
            w.write(data[i : i + 7001])
        w.close()
    with open(p, "rb") as f:
        r = BgzfReader(f)
        assert r.read(len(data) + 10) == data
    # gzip interop: the blocks are standard gzip members
    import gzip

    with gzip.open(p, "rb") as f:
        assert f.read() == data


def test_bam_roundtrip(tmp_path):
    recs = [
        BamRecord(
            query_name="read1",
            flag=0,
            reference_id=0,
            reference_start=100,
            mapq=60,
            cigartuples=[(CSOFT_CLIP, 5), (CMATCH, 50), (CREF_SKIP, 200), (CMATCH, 30), (CSOFT_CLIP, 3)],
            query_sequence="ACGT" * 22,
        ),
        BamRecord(
            query_name="read2",
            flag=FLAG_REVERSE,
            reference_id=0,
            reference_start=150,
            mapq=60,
            cigartuples=[(CMATCH, 40)],
            query_sequence="A" * 40,
        ),
    ]
    p = str(tmp_path / "t.bam")
    with BamWriter(p, ["chrT"], [1_000_000]) as w:
        for r in recs:
            w.write(r)
    with BamReader(p) as rd:
        assert rd.references == ["chrT"]
        assert rd.lengths == [1_000_000]
        got = list(rd)
    assert len(got) == 2
    for a, b in zip(recs, got):
        assert a.query_name == b.query_name
        assert a.flag == b.flag
        assert a.reference_start == b.reference_start
        assert a.cigartuples == b.cigartuples
        assert a.query_sequence == b.query_sequence
        assert b.reference_name == "chrT"
    assert got[1].is_reverse and not got[0].is_reverse


def test_fastx(tmp_path):
    p = str(tmp_path / "r.fastq")
    write_fastq(p, [("r1 extra", "ACGT"), ("r2", "GGTT")])
    # write_fastq writes the name verbatim; reader takes first token
    got = list(read_fastx(p))
    assert got == [("r1", "ACGT"), ("r2", "GGTT")]

    fa = str(tmp_path / "r.fa")
    with open(fa, "w") as f:
        f.write(">a desc\nAAAA\n>b\nCCCC\n")
    assert list(read_fastx(fa)) == [("a", "AAAA"), ("b", "CCCC")]
