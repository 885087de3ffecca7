"""Golden-file regression: the committed wire-format outputs for a fixed
simulation must reproduce byte-for-byte.

These catch unintended drift in any stage's algorithm or TSV/GTF format.
If a change breaks them *intentionally* (an algorithmic fix), regenerate
the fixtures with the snippet in this file's docstring and explain the
diff in the commit message.

Regenerate:
    python - <<'PY'
    # see tests/test_golden.py::_regenerate for the exact recipe
    PY
"""

import os
import shutil

import pytest

from freddie_jax.config import PipelineConfig
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.sim import simulate

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

SIM_KWARGS = dict(
    seed=1234, n_genes=2, isoforms_per_gene=2, reads_per_isoform=6,
    minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.9,
)


@pytest.fixture(scope="module")
def fresh_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden_run")
    sim = simulate(**SIM_KWARGS)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(d / "out")
    run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    return out


def _diff(golden_path, fresh_path):
    g = open(golden_path).read()
    f = open(fresh_path).read()
    assert g == f, f"{os.path.basename(golden_path)} drifted from golden"


@pytest.mark.parametrize("stage,pattern", [
    ("split", "split_chr1_{t}.tsv"),
    ("segment", "segment_chr1_{t}.tsv"),
    ("cluster", "cluster_chr1_{t}.tsv"),
])
def test_stage_outputs_match_golden(fresh_run, stage, pattern):
    for t in (0, 1):
        name = pattern.format(t=t)
        _diff(
            os.path.join(GOLDEN, stage, name),
            os.path.join(fresh_run, stage, "chr1", name),
        )


def test_gtf_matches_golden(fresh_run):
    _diff(os.path.join(GOLDEN, "isoforms.gtf"), os.path.join(fresh_run, "isoforms.gtf"))
