"""Failure-detection / elastic-recovery behavior: crash-safe outputs and
resume semantics (SURVEY.md §5 -- the reference delegates this to
Snakemake's DAG; here the stage driver owns it)."""

import json
import os
import shutil

import pytest

from freddie_jax.config import ClusterConfig, PipelineConfig
from freddie_jax.stages.cluster import run_cluster
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.fsio import MARKER, atomic_write, is_complete
from freddie_jax.utils.sim import simulate


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    d = tmp_path_factory.mktemp("fault")
    sim = simulate(seed=13)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(d / "out")
    run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *_: None)
    return bam, fq, out


def test_atomic_write_crash_leaves_no_partial(tmp_path):
    path = str(tmp_path / "x.tsv")
    with pytest.raises(RuntimeError):
        with atomic_write(path) as f:
            f.write("half a row")
            raise RuntimeError("crash mid-write")
    assert not os.path.exists(path)
    assert not os.path.exists(path + ".tmp")
    with atomic_write(path) as f:
        f.write("complete\n")
    assert open(path).read() == "complete\n"


def test_pipeline_stages_marked_complete(pipe):
    _bam, _fq, out = pipe
    for stage in ("split", "segment", "cluster"):
        assert is_complete(os.path.join(out, stage)), stage
    assert is_complete(os.path.join(out, "isoforms.gtf"))


def test_resume_skips_complete_and_redoes_crashed_stage(pipe):
    bam, fq, out = pipe
    work = out + "_resume"
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(out, work)
    # Simulate a crash during cluster: marker missing + a stray partial.
    os.remove(os.path.join(work, "cluster", MARKER))
    stray = os.path.join(work, "cluster", "chr1", "cluster_chr1_0.tsv.tmp")
    with open(stray, "w") as f:
        f.write("partial")
    os.remove(os.path.join(work, "isoforms.gtf"))
    kept = {}
    for root, _dirs, fns in os.walk(os.path.join(work, "cluster")):
        for fn in fns:
            if fn.endswith(".tsv"):
                p = os.path.join(root, fn)
                kept[p] = os.path.getmtime(p)
    logs = []
    run_pipeline(bam, [fq], work, PipelineConfig(), resume=True,
                 log=logs.append)
    for p, m in kept.items():  # completed tints were reused, not redone
        assert os.path.getmtime(p) == m, p
    text = "\n".join(logs)
    assert "split: complete, skipping" in text
    assert "segment: complete, skipping" in text
    # Cluster's per-tint writes are atomic and already-written tints are
    # skipped, so the crashed stage resumes IN PLACE (completed tints
    # are not thrown away) and stray temp files are swept.
    assert "cluster: incomplete output, resuming in place" in text
    assert not os.path.exists(stray)
    assert is_complete(os.path.join(work, "cluster"))
    # Deterministic stages: the re-run reproduces the original bytes.
    for root, _dirs, fns in os.walk(os.path.join(out, "cluster")):
        for fn in fns:
            if fn == MARKER:
                continue
            a = os.path.join(root, fn)
            b = a.replace(out, work, 1)
            assert open(a).read() == open(b).read(), fn
    assert (
        open(os.path.join(work, "isoforms.gtf")).read()
        == open(os.path.join(out, "isoforms.gtf")).read()
    )


def test_cluster_per_tint_resume_recomputes_only_missing(pipe, tmp_path):
    _bam, _fq, out = pipe
    seg_dir = os.path.join(out, "segment")
    redo = str(tmp_path / "cluster_redo")
    shutil.copytree(os.path.join(out, "cluster"), redo)
    # Drop one tint's output; leave a stray .tmp from a "crash".
    victims = []
    for root, _dirs, fns in os.walk(redo):
        for fn in sorted(fns):
            if fn.startswith("cluster_") and fn.endswith(".tsv"):
                victims.append(os.path.join(root, fn))
    assert victims
    os.remove(victims[0])
    with open(victims[0] + ".tmp", "w") as f:
        f.write("partial")
    mtimes = {p: os.path.getmtime(p) for p in victims[1:]}
    run_cluster(seg_dir, redo, ClusterConfig())
    # Missing tint recomputed byte-identically; others untouched.
    orig = victims[0].replace(redo, os.path.join(out, "cluster"), 1)
    assert open(victims[0]).read() == open(orig).read()
    for p, m in mtimes.items():
        assert os.path.getmtime(p) == m, f"{p} was rewritten"


def test_cluster_pool_degrades_to_threads(pipe, tmp_path, monkeypatch):
    """A broken spawn pool (workers dying at startup -- container limits,
    signal storms) must degrade to the thread path mid-stage, with any
    tints the pool completed before breaking resumed idempotently and
    the final outputs byte-identical to a healthy run."""
    from concurrent.futures.process import BrokenProcessPool

    import freddie_jax.stages.cluster as cl

    _bam, _fq, out = pipe
    seg_dir = os.path.join(out, "segment")
    monkeypatch.setattr(cl, "POOL_MIN_BYTES", 0)  # force the pool branch

    class _Broken:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def map(self, *a, **k):
            raise BrokenProcessPool("simulated worker death")

    import concurrent.futures

    monkeypatch.setattr(concurrent.futures, "ProcessPoolExecutor", _Broken)
    redo = str(tmp_path / "cluster_degraded")
    n = run_cluster(seg_dir, redo, ClusterConfig(threads=2))
    assert n > 0
    for root, _dirs, fns in os.walk(os.path.join(out, "cluster")):
        for fn in fns:
            if fn.startswith("cluster_") and fn.endswith(".tsv"):
                a = os.path.join(root, fn)
                b = a.replace(os.path.join(out, "cluster"), redo, 1)
                assert open(a).read() == open(b).read(), fn


def test_solver_timeout_routes_reads_to_garbage(pipe, monkeypatch):
    """The reference's Gurobi TimeLimit -> non-OPTIMAL -> garbage semantics
    (py/freddie_cluster.py:750-751,767-773): a solver that cannot prove
    optimality must stop the round loop and recycle the partition."""
    from freddie_jax.io.tsv import parse_segment_tsv
    from freddie_jax.solver.exact import SolveResult
    from freddie_jax.stages import cluster as cl

    _bam, _fq, out = pipe
    seg_dir = os.path.join(out, "segment")
    paths = []
    for root, _dirs, fns in os.walk(seg_dir):
        for fn in sorted(fns):
            if fn.startswith("segment_"):
                paths.append(os.path.join(root, fn))
    tint = parse_segment_tsv(paths[0])
    monkeypatch.setattr(
        cl, "_solve",
        lambda inst, deadline_s: SolveResult("TIMEOUT", 0.0, [], None),
    )
    isoforms, garbage = cl.cluster_tint(tint, ClusterConfig())
    assert isoforms == []
    assert sorted(garbage) == list(range(len(tint.read_reps)))


def test_protected_outputs(pipe, tmp_path):
    """protect=True = the Snakefile's protected() analog: completed stage
    outputs are read-only; a forced re-run restores writability. (Mode
    bits are asserted directly -- root bypasses permission checks, so
    PermissionError cannot be relied on in this container.)"""
    import stat

    bam, fq, _out = pipe
    work = str(tmp_path / "prot")
    run_pipeline(bam, [fq], work, PipelineConfig(), protect=True,
                 log=lambda *_: None)
    W = stat.S_IWUSR | stat.S_IWGRP | stat.S_IWOTH
    victims = []
    for root, _dirs, fns in os.walk(os.path.join(work, "cluster")):
        for fn in fns:
            if fn.endswith(".tsv"):
                victims.append(os.path.join(root, fn))
    assert victims
    for v in victims:
        assert os.stat(v).st_mode & W == 0, v
    assert os.stat(os.path.join(work, "isoforms.gtf")).st_mode & W == 0
    # Forced (non-resume) re-run succeeds over the protected outputs and
    # re-protects the fresh ones.
    run_pipeline(bam, [fq], work, PipelineConfig(), protect=True,
                 log=lambda *_: None)
    assert os.stat(os.path.join(work, "isoforms.gtf")).st_mode & W == 0


def test_stage_retry_orchestration(pipe, tmp_path, monkeypatch):
    """cfg.retries re-runs a stage that raises (the Snakemake scheduler's
    rule-retry analog): a transiently failing segment stage succeeds on
    the second attempt and the pipeline completes normally; with
    retries=0 the same fault propagates."""
    from freddie_jax.stages import pipeline as pl

    bam, fq, out = pipe
    calls = {"n": 0}
    real = pl.run_segment

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient fault injected")
        return real(*a, **k)

    monkeypatch.setattr(pl, "run_segment", flaky)
    work = str(tmp_path / "retry")
    logs = []
    stats = run_pipeline(bam, [fq], work, PipelineConfig(retries=1),
                         log=logs.append)
    assert calls["n"] == 2
    assert any("segment: attempt 1 failed; retrying" in l for l in logs)
    assert (
        open(os.path.join(work, "isoforms.gtf")).read()
        == open(os.path.join(out, "isoforms.gtf")).read()
    )

    calls["n"] = 0
    with pytest.raises(OSError):
        run_pipeline(bam, [fq], str(tmp_path / "retry0"), PipelineConfig(),
                     log=lambda *_: None)
