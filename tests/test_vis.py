"""Visualization stages smoke tests (plot PDFs + segment_vis pickle),
function-level and through the CLI."""

import os
import pickle
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from freddie_jax.config import PipelineConfig
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.sim import simulate


@pytest.fixture(scope="module")
def full_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("vis")
    sim = simulate(seed=12, n_genes=1, isoforms_per_gene=2, reads_per_isoform=6)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    gtf = str(d / "annot.gtf")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    sim.write_annotation_gtf(gtf)
    out = str(d / "out")
    run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    return sim, out, gtf


def test_plot_produces_pdfs(full_run):
    sim, out, gtf = full_run
    from freddie_jax.stages.plot import run_plot

    plot_dir = os.path.join(out, "plots")
    n = run_plot(
        annotation_gtf=gtf,
        segment_tsv=os.path.join(out, "segment", sim.contig, f"segment_{sim.contig}_0.tsv"),
        cluster_tsv=os.path.join(out, "cluster", sim.contig, f"cluster_{sim.contig}_0.tsv"),
        out_dir=plot_dir,
    )
    assert n >= 1
    pdfs = [
        os.path.join(r, f)
        for r, _, fs in os.walk(plot_dir)
        for f in fs
        if f.endswith(".pdf")
    ]
    assert pdfs and all(os.path.getsize(p) > 1000 for p in pdfs)


def test_segment_vis_pickle(full_run):
    sim, out, gtf = full_run
    from freddie_jax.stages.segment_vis import run_segment_vis

    pkl = os.path.join(out, "segvis.pickle")
    run_segment_vis(
        split_tsvs=[os.path.join(out, "split", sim.contig, f"split_{sim.contig}_0.tsv")],
        segment_tsvs=[os.path.join(out, "segment", sim.contig, f"segment_{sim.contig}_0.tsv")],
        annotation_gtf=gtf,
        output=pkl,
    )
    segs, transcripts, reads = pickle.load(open(pkl, "rb"))
    assert sim.contig in segs and sim.contig in reads
    assert len(reads[sim.contig]) > 0
    for read in reads[sim.contig]:
        assert "data" in read
    # annotation transcripts got data too
    for t in transcripts[sim.contig].values():
        assert "data" in t


def _run_cli(args, timeout=180):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + ":" + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "freddie_jax.cli"] + args,
        capture_output=True, text=True, env=env, timeout=timeout,
    )
    assert proc.returncode == 0, proc.stderr[-500:]


def test_plot_cli(full_run, tmp_path):
    sim, out, gtf = full_run
    plot_dir = str(tmp_path / "plots")
    _run_cli([
        "plot", "-a", gtf,
        "-s", os.path.join(out, "segment", sim.contig, f"segment_{sim.contig}_0.tsv"),
        "-c", os.path.join(out, "cluster", sim.contig, f"cluster_{sim.contig}_0.tsv"),
        "-od", plot_dir,
    ])
    pdfs = [f for r, _, fs in os.walk(plot_dir) for f in fs if f.endswith(".pdf")]
    assert pdfs


def test_segment_vis_cli(full_run, tmp_path):
    sim, out, gtf = full_run
    pkl = str(tmp_path / "sv.pickle")
    _run_cli([
        "segment-vis",
        "-s", os.path.join(out, "split", sim.contig, f"split_{sim.contig}_0.tsv"),
        "-g", os.path.join(out, "segment", sim.contig, f"segment_{sim.contig}_0.tsv"),
        "-a", gtf, "-o", pkl,
    ])
    segs, transcripts, reads = pickle.load(open(pkl, "rb"))
    assert sim.contig in segs and len(reads[sim.contig]) > 0


def test_plot_truth_tids_and_tails(full_run):
    """Reads carry their simulation-truth transcript id and parsed polyA
    tail info through load_tints (the reference's truth-coloring workflow,
    py/freddie_plot.py:359-376)."""
    sim, out, gtf = full_run
    from freddie_jax.stages.plot import load_tints, truth_tid

    tints = load_tints(
        os.path.join(out, "cluster", sim.contig, f"cluster_{sim.contig}_0.tsv"),
        os.path.join(out, "segment", sim.contig, f"segment_{sim.contig}_0.tsv"),
    )
    true_tids = {t.name for t in sim.transcripts}
    seen_tids = set()
    n_tails = 0
    for tint in tints.values():
        for part in tint["partitions"].values():
            for iso in part["isoforms"].values():
                for read in iso["reads"]:
                    assert read["tid"] == truth_tid(read["name"])
                    assert read["tid"] in true_tids
                    seen_tids.add(read["tid"])
                    assert len(read["gaps"]) == len(read["data"])
                    t = read["tail"]
                    if t["s_len"] or t["e_len"]:
                        n_tails += 1
    assert len(seen_tids) >= 2  # both isoforms' truth ids distinguished
    assert n_tails > 0  # simulated polyA tails made it into the panels


@pytest.fixture(scope="module")
def two_gene_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("vispool")
    sim = simulate(seed=13, n_genes=3, isoforms_per_gene=2, reads_per_isoform=6)
    bam, fq = str(d / "r.bam"), str(d / "r.fastq")
    gtf = str(d / "annot.gtf")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    sim.write_annotation_gtf(gtf)
    out = str(d / "out")
    run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    return sim, out, gtf


def test_plot_pool_matches_serial(two_gene_run, tmp_path, monkeypatch):
    """threads>1 fans tints over a process pool (the reference's -t,
    py/freddie_plot.py:60-64); with SOURCE_DATE_EPOCH pinned, every PDF
    is byte-identical to the serial render."""
    import filecmp
    import glob

    sim, out, gtf = two_gene_run
    from freddie_jax.stages.plot import run_plot

    seg_tsvs = sorted(glob.glob(os.path.join(out, "segment", "*", "segment_*.tsv")))
    clu_tsvs = sorted(glob.glob(os.path.join(out, "cluster", "*", "cluster_*.tsv")))
    assert len(seg_tsvs) >= 2, "need multiple tints to exercise the pool"
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "946684800")
    counts = {}
    for label, threads in (("serial", 1), ("pool", 3)):
        total = 0
        for seg, clu in zip(seg_tsvs, clu_tsvs):
            total += run_plot(
                annotation_gtf=gtf, segment_tsv=seg, cluster_tsv=clu,
                out_dir=str(tmp_path / label), threads=threads,
            )
        counts[label] = total
    assert counts["serial"] == counts["pool"] >= 2
    serial = sorted(
        os.path.relpath(os.path.join(r, f), tmp_path / "serial")
        for r, _, fs in os.walk(tmp_path / "serial") for f in fs
    )
    pool = sorted(
        os.path.relpath(os.path.join(r, f), tmp_path / "pool")
        for r, _, fs in os.walk(tmp_path / "pool") for f in fs
    )
    assert serial == pool and serial
    for rel in serial:
        assert filecmp.cmp(
            str(tmp_path / "serial" / rel), str(tmp_path / "pool" / rel),
            shallow=False,
        ), rel
