"""Alignment orchestration: SAM parsing + own-codec coordinate sort
(the samtools-free half of the reference's minimap2 rule,
/root/reference/Snakefile:30-47). minimap2 itself is external and absent
in this image, so its invocation is covered by the error-path test."""

import random

import pytest

from freddie_jax.io.align import align_reads, minimap2_available, sam_to_sorted_bam
from freddie_jax.io.bam import CIGAR_OPS, BamReader
from freddie_jax.utils.sim import simulate


def _to_sam(sim) -> list[str]:
    """Render a simulation's reads as SAM text (shuffled, to exercise the
    coordinate sort)."""
    lines = [
        "@HD\tVN:1.6\tSO:unsorted\n",
        f"@SQ\tSN:{sim.contig}\tLN:{sim.contig_len}\n",
    ]
    body = []
    for r in sim.reads:
        cig = "".join(f"{n}{CIGAR_OPS[op]}" for op, n in r.cigar)
        flag = 16 if r.strand == "-" else 0
        body.append(
            f"{r.name}\t{flag}\t{sim.contig}\t{r.pos + 1}\t60\t{cig}\t*\t0\t0\t"
            f"{r.aligned_seq}\t*\n"
        )
    random.Random(5).shuffle(body)
    return lines + body


def test_sam_to_sorted_bam_roundtrip(tmp_path):
    sim = simulate(seed=14, n_genes=2, isoforms_per_gene=2, reads_per_isoform=5,
                   minus_strand_genes=True)
    ref_bam = str(tmp_path / "ref.bam")
    sim.write_bam(ref_bam)
    out_bam = str(tmp_path / "sorted.bam")
    n = sam_to_sorted_bam(_to_sam(sim), out_bam)
    assert n == len(sim.reads)
    with BamReader(ref_bam) as r:
        want = [(x.query_name, x.flag, x.reference_start,
                 tuple(map(tuple, x.cigartuples)), x.query_sequence) for x in r]
    with BamReader(out_bam) as r:
        assert r.references == [sim.contig]
        got = [(x.query_name, x.flag, x.reference_start,
                tuple(map(tuple, x.cigartuples)), x.query_sequence) for x in r]
    # same coordinate order and content (ties may legitimately reorder;
    # compare as sorted multisets and assert positions nondecreasing)
    pos = [g[2] for g in got]
    assert pos == sorted(pos)
    assert sorted(got) == sorted(want)


def test_align_reads_requires_minimap2(tmp_path):
    if minimap2_available():
        pytest.skip("minimap2 present; error path not applicable")
    with pytest.raises(RuntimeError, match="minimap2 not found"):
        align_reads(str(tmp_path / "g.fa"), [str(tmp_path / "r.fq")],
                    str(tmp_path / "o.bam"))
