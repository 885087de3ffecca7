"""Config-driven multi-sample workflow runner (the Snakemake equivalent,
reference Snakefile:22-121 + config.yaml): YAML config, per-stage
parameter overrides, dotted-path override mechanism, resume semantics,
and the CLI entry point."""

import os
import subprocess
import sys

import pytest

from freddie_jax.stages.workflow import (
    apply_overrides,
    load_workflow_config,
    run_workflow,
)
from freddie_jax.utils.sim import simulate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wf")
    paths = {}
    for name, seed in (("S1", 101), ("S2", 202)):
        sim = simulate(seed=seed, n_genes=2, isoforms_per_gene=2,
                       reads_per_isoform=8)
        bam, fq = str(d / f"{name}.bam"), str(d / f"{name}.fastq")
        sim.write_bam(bam)
        sim.write_fastq(fq)
        paths[name] = (bam, fq, len(sim.transcripts))
    return d, paths


def _config(d, paths, out):
    return {
        "outpath": str(out),
        "samples": {
            name: {"bam": bam, "reads": [fq]}
            for name, (bam, fq, _) in paths.items()
        },
        "stages": {"segment": {"sigma": 5.0}},
    }


def test_two_sample_workflow(inputs, tmp_path):
    d, paths = inputs
    results = run_workflow(_config(d, paths, tmp_path / "out"), log=lambda *a: None)
    assert set(results) == {"S1", "S2"}
    for name, (_, _, n_true) in paths.items():
        gtf = os.path.join(tmp_path, "out", "results", name, "isoforms.gtf")
        lines = open(gtf).read().splitlines()
        n_tr = sum(1 for l in lines if l.split("\t")[2] == "transcript")
        assert n_tr == n_true, (name, n_tr, n_true)


def test_resume_skips_completed_samples(inputs, tmp_path):
    d, paths = inputs
    cfg = _config(d, paths, tmp_path / "out")
    run_workflow(cfg, log=lambda *a: None)
    gtf = os.path.join(tmp_path, "out", "results", "S1", "isoforms.gtf")
    before = os.path.getmtime(gtf)
    run_workflow(cfg, resume=True, log=lambda *a: None)
    assert os.path.getmtime(gtf) == before  # untouched on resume


def test_dotted_overrides():
    raw = {"outpath": "x", "stages": {"segment": {"sigma": 5.0}}}
    apply_overrides(raw, {"stages.segment.sigma": 3.0,
                          "stages.cluster.timeout": 1.5,
                          "outpath": "y"})
    assert raw["stages"]["segment"]["sigma"] == 3.0
    assert raw["stages"]["cluster"]["timeout"] == 1.5
    assert raw["outpath"] == "y"


def test_yaml_config_and_cli(inputs, tmp_path):
    d, paths = inputs
    bam, fq, n_true = paths["S1"]
    cfg_path = str(tmp_path / "wf.yaml")
    with open(cfg_path, "w") as f:
        f.write(
            f"outpath: {tmp_path}/out\n"
            "samples:\n"
            "  S1:\n"
            f"    bam: {bam}\n"
            f"    reads: [{fq}]\n"
        )
    loaded = load_workflow_config(cfg_path, {"stages.cluster.timeout": 2.0})
    assert loaded["stages"]["cluster"]["timeout"] == 2.0
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "freddie_jax.cli", "workflow", cfg_path,
         "--set", "stages.segment.sigma=5.0"],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-500:]
    gtf = os.path.join(tmp_path, "out", "results", "S1", "isoforms.gtf")
    lines = open(gtf).read().splitlines()
    assert sum(1 for l in lines if l.split("\t")[2] == "transcript") == n_true
