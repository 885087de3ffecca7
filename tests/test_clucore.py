"""Consolidated native cluster engine (native/clucore.cpp): whole-stage
outputs must be byte-identical to the Python oracle path across sim
configs, recycle models, and the escalation-fallback route."""

import filecmp
import os

import pytest

from freddie_jax.config import ClusterConfig, SegmentConfig, SplitConfig
from freddie_jax.solver.clucore import load_clucore
from freddie_jax.stages.cluster import run_cluster
from freddie_jax.stages.segment import run_segment
from freddie_jax.stages.split import run_split
from freddie_jax.utils.sim import simulate

eng = load_clucore()
pytestmark = pytest.mark.skipif(eng is None, reason="clucore did not build")

CONFIGS = {
    # polyA-heavy with truncation: exercises S/E categories, virtual tail
    # gaps, and the partition category gate
    31: dict(seed=31),
    # dense/noisy: alt splice + jitter + big deletions drive real
    # multi-round solves and non-trivial partitions
    88: dict(
        seed=88, n_genes=3, isoforms_per_gene=4, reads_per_isoform=25,
        minus_strand_genes=True, truncate_prob=0.25, tail_prob=0.8,
        end_jitter=25, indel_rate=0.1, alt_splice=True, junction_jitter=6,
        big_del_rate=0.06,
    ),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def segment_dir(tmp_path_factory, request):
    d = tmp_path_factory.mktemp(f"clucore{request.param}")
    sim = simulate(**CONFIGS[request.param])
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    split = str(d / "split")
    run_split(bam, [fq], split, SplitConfig())
    seg = str(d / "segment")
    run_segment(split, seg, SegmentConfig())
    return seg


def _tsv_set(outdir):
    return sorted(
        os.path.join(r, f)
        for r, _dirs, fns in os.walk(outdir)
        for f in fns
        if f.endswith(".tsv")
    )


def _compare_runs(segment_dir, tmp_path, monkeypatch, cfg):
    py_out = str(tmp_path / "py")
    nat_out = str(tmp_path / "nat")
    monkeypatch.setenv("FREDDIE_CLUCORE", "0")
    run_cluster(segment_dir, py_out, cfg)
    monkeypatch.delenv("FREDDIE_CLUCORE")
    run_cluster(segment_dir, nat_out, cfg)
    py_files = _tsv_set(py_out)
    nat_files = _tsv_set(nat_out)
    assert [os.path.relpath(f, py_out) for f in py_files] == [
        os.path.relpath(f, nat_out) for f in nat_files
    ]
    assert py_files
    for a, b in zip(py_files, nat_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, py_out)


@pytest.mark.parametrize(
    "recycle_model", ["constant", "exons", "introns"]
)
def test_stage_byte_identical(segment_dir, tmp_path, monkeypatch, recycle_model):
    _compare_runs(
        segment_dir, tmp_path, monkeypatch, ClusterConfig(recycle_model=recycle_model)
    )


def test_nondefault_knobs(segment_dir, tmp_path, monkeypatch):
    """gap_offset/epsilon/min_isoform_size/max_ilp off-defaults still match."""
    _compare_runs(
        segment_dir, tmp_path, monkeypatch,
        ClusterConfig(gap_offset=5, epsilon=0.25, min_isoform_size=5, max_ilp=4),
    )


def test_escalation_falls_back(segment_dir, tmp_path, monkeypatch):
    """Forcing the device-bounds gate (status 5) on every closure makes the
    native engine decline; the stage falls back per tint and stays
    byte-identical."""
    import freddie_jax.solver.clucore as cc

    orig = cc.cluster_tint_native
    calls = {"n": 0, "none": 0}

    def tiny_gate(in_path, cfg):
        calls["n"] += 1
        import freddie_jax.solver.segenum as se

        saved = se.BOUNDS_DEVICE_MIN
        se.BOUNDS_DEVICE_MIN = 1  # any closure escalation -> status 5
        try:
            out = orig(in_path, cfg)
        finally:
            se.BOUNDS_DEVICE_MIN = saved
        if out is None:
            calls["none"] += 1
        return out

    py_out = str(tmp_path / "py")
    nat_out = str(tmp_path / "nat")
    monkeypatch.setenv("FREDDIE_CLUCORE", "0")
    run_cluster(segment_dir, py_out, ClusterConfig())
    monkeypatch.delenv("FREDDIE_CLUCORE")
    monkeypatch.setattr(cc, "cluster_tint_native", tiny_gate)
    import freddie_jax.stages.cluster  # noqa: F401  (binds via module attr)

    run_cluster(segment_dir, nat_out, ClusterConfig())
    assert calls["n"] > 0
    py_files = _tsv_set(py_out)
    nat_files = _tsv_set(nat_out)
    for a, b in zip(py_files, nat_files):
        assert filecmp.cmp(a, b, shallow=False), os.path.relpath(a, py_out)


def test_parse_error_falls_back(tmp_path, monkeypatch):
    """A malformed-but-Python-parsable input degrades to the Python path
    (the native grammar is stricter by design)."""
    # The Python regex parser scans gap tokens permissively; a token the
    # C grammar rejects must not fail the stage.
    d = tmp_path / "seg" / "chrX"
    os.makedirs(d)
    (d / "segment_chrX_0.tsv").write_text(
        "#chrX\t0\t100,200,300\n"
        "0\tr0\tchrX\t+\t0\t11\tjunk~token,SSC:5,ESC:0,\n"
        "1\tr1\tchrX\t+\t0\t11\tSSC:0,ESC:0,\n"
        "2\tr2\tchrX\t+\t0\t11\tSSC:0,ESC:0,\n"
    )
    out = str(tmp_path / "out")
    run_cluster(str(tmp_path / "seg"), out, ClusterConfig())
    files = _tsv_set(out)
    assert len(files) == 1


def test_adversarial_synthetic_tints(tmp_path, monkeypatch):
    """Random synthetic segment TSVs (M up to 100 -> two-word masks,
    random polyA categories/gap tokens/recycle models, max_ilp splits)
    through native vs Python cluster, byte-compared."""
    import random

    def make_tint(rng, M, n_reads, tid):
        pos = sorted(rng.sample(range(1000, 1000000), M + 1))
        lines = [f"#chrX\t{tid}\t{','.join(map(str, pos))}"]
        for rid in range(n_reads):
            data = "".join(rng.choice("0012") for _ in range(M))
            toks = []
            if rng.random() < 0.6:
                a = rng.randrange(0, M - 1)
                b = rng.randrange(a + 1, M)
                toks.append(f"{a}-{b}:{rng.randrange(0, 40)}")
            toks.append(f"SSC:{rng.randrange(0, 30)}")
            toks.append(f"ESC:{rng.randrange(0, 30)}")
            if rng.random() < 0.5:
                side = rng.choice(["SA", "ST", "EA", "ET"])
                toks.append(f"{side}_{rng.randrange(0, 40)}:{rng.randrange(0, 30)}")
            gaps = ",".join(sorted(toks)) + ","
            lines.append(f"{rid}\tr{rid}\tchrX\t+\t{tid}\t{data}\t{gaps}")
        return "\n".join(lines) + "\n"

    for trial in range(8):
        rng = random.Random(1000 + trial)
        d = tmp_path / f"t{trial}"
        os.makedirs(d / "seg" / "chrX")
        M = rng.choice([2, 3, 9, 40, 70, 100])
        n = rng.randrange(3, 40)
        (d / "seg" / "chrX" / "segment_chrX_0.tsv").write_text(
            make_tint(rng, M, n, 0)
        )
        cfg = ClusterConfig(
            recycle_model=rng.choice(["constant", "exons", "introns"]),
            max_ilp=rng.choice([4, 1000]),
        )
        monkeypatch.setenv("FREDDIE_CLUCORE", "0")
        run_cluster(str(d / "seg"), str(d / "py"), cfg)
        monkeypatch.delenv("FREDDIE_CLUCORE")
        run_cluster(str(d / "seg"), str(d / "nat"), cfg)
        a = (d / "py" / "chrX" / "cluster_chrX_0.tsv").read_text()
        b = (d / "nat" / "chrX" / "cluster_chrX_0.tsv").read_text()
        assert a == b, f"trial {trial}: M={M} n={n} {cfg.recycle_model}"
