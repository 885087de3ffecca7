"""The C++ split core (native/split_core.cpp) is a byte-identical twin of
the Python split stage (stages/split.py) -- whole output trees compared
across configs: noisy/minus-strand/truncated reads, nonspliced handling,
oversize-tint breaking, gzipped FASTQ input, and multi-file routing."""

import filecmp
import gzip
import os

import pytest

from freddie_jax.config import SplitConfig
from freddie_jax.io.bam_native import native_split_available
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate

pytestmark = pytest.mark.skipif(
    not native_split_available(), reason="no C++ toolchain"
)


def _tree(root):
    out = []
    for r, _d, fns in os.walk(root):
        for fn in fns:
            out.append(os.path.relpath(os.path.join(r, fn), root))
    return sorted(out)


def _assert_trees_equal(a, b):
    files = _tree(a)
    assert files == _tree(b) and files
    for rel in files:
        assert filecmp.cmp(
            os.path.join(a, rel), os.path.join(b, rel), shallow=False
        ), rel


def _run_both(tmp_path, bam, read_files, cfg, tag=""):
    out_native = str(tmp_path / f"native{tag}")
    out_py = str(tmp_path / f"py{tag}")
    os.environ["FREDDIE_SPLIT_ENGINE"] = "native"
    try:
        counts_native = run_split(bam, read_files, out_native, cfg)
        os.environ["FREDDIE_SPLIT_ENGINE"] = "python"
        counts_py = run_split(bam, read_files, out_py, cfg)
    finally:
        del os.environ["FREDDIE_SPLIT_ENGINE"]
    assert counts_native == counts_py
    _assert_trees_equal(out_native, out_py)
    return counts_native


def test_noisy_dataset_byte_identical(tmp_path):
    sim = simulate(
        seed=29, n_genes=6, isoforms_per_gene=3, reads_per_isoform=25,
        minus_strand_genes=True, truncate_prob=0.3, tail_prob=0.7,
        end_jitter=30, indel_rate=0.12, alt_splice=True, junction_jitter=8,
        big_del_rate=0.08,
    )
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    counts = _run_both(tmp_path, bam, [fq], SplitConfig())
    assert sum(counts.values()) >= 6


def test_nonspliced_and_oversize_break(tmp_path):
    sim = simulate(seed=31, n_genes=4, isoforms_per_gene=3, reads_per_isoform=30)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    # consider_nonspliced on.
    _run_both(tmp_path, bam, [fq], SplitConfig(consider_nonspliced=True), tag="_ns")
    # Tiny read cap: every tint goes through break_oversized_tint.
    counts = _run_both(
        tmp_path, bam, [fq], SplitConfig(max_tint_reads=20), tag="_break"
    )
    assert sum(counts.values()) >= 4


def test_gz_and_multifile_routing(tmp_path):
    sim = simulate(seed=37, n_genes=3, reads_per_isoform=15)
    bam = str(tmp_path / "r.bam")
    sim.write_bam(bam)
    # Route half the reads from a gzipped FASTQ, half from a plain one --
    # file order determines row order in the reads TSVs.
    half = len(sim.reads) // 2
    fq1 = str(tmp_path / "a.fastq.gz")
    with gzip.open(fq1, "wt") as f:
        for r in sim.reads[:half]:
            f.write(f"@{r.name} extra descr\n{r.fastq_seq}\n+\n{'I' * len(r.fastq_seq)}\n")
    fq2 = str(tmp_path / "b.fastq")
    with open(fq2, "w") as f:
        for r in sim.reads[half:]:
            f.write(f"@{r.name}\n{r.fastq_seq}\n+\n{'I' * len(r.fastq_seq)}\n")
    _run_both(tmp_path, bam, [fq1, fq2], SplitConfig())
