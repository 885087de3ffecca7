"""End-to-end pipeline driver: split -> segment -> cluster -> isoforms.

Plays the role of the reference's Snakemake DAG (Snakefile:22-121) with the
same checkpoint semantics: each stage writes its directory of TSVs and any
stage can be re-run from the previous one's outputs (`resume=True` skips
stages whose outputs already exist)."""

from __future__ import annotations

import os

from ..config import PipelineConfig
from .cluster import run_cluster
from .isoforms import run_isoforms
from .segment import run_segment
from .split import run_split


def stage_engine(name: str, cfg: PipelineConfig) -> str:
    """Which engine runs a stage: "native" when its C/C++ engine is built
    and enabled, else "python" (the byte-identical oracle twin). A failed
    native build changes only speed, so the stage log names the engine to
    make that visible."""
    if name == "split":
        from ..io.bam_native import native_split_available

        on = (os.environ.get("FREDDIE_SPLIT_ENGINE", "auto") != "python"
              and native_split_available())
    elif name == "segment":
        from ..ops.segcore import load_segcore

        on = (os.environ.get("FREDDIE_SEGCORE") != "0"
              and load_segcore() is not None)
    elif name == "cluster":
        from ..solver.clucore import load_clucore

        on = cfg.cluster.logs_dir is None and load_clucore() is not None
    else:
        from ..ops.isocore import load_isocore

        on = load_isocore() is not None
    return "native" if on else "python"


def run_pipeline(
    bam: str,
    reads: list[str],
    outdir: str,
    cfg: PipelineConfig | None = None,
    resume: bool = False,
    protect: bool = False,
    log=print,
) -> dict:
    """protect=True makes each completed stage's outputs read-only (the
    Snakefile's protected() analog, Snakefile:35-36,112): accidental
    rewrites fail loudly; a forced re-run chmods them back first."""
    from ..utils.procenv import use_compile_cache

    use_compile_cache()
    cfg = cfg or PipelineConfig()
    os.makedirs(outdir, exist_ok=True)
    split_dir = os.path.join(outdir, "split")
    segment_dir = os.path.join(outdir, "segment")
    cluster_dir = os.path.join(outdir, "cluster")
    gtf_path = os.path.join(outdir, "isoforms.gtf")
    stats: dict = {}

    from ..utils.metrics import StageMetrics

    from ..utils.fsio import is_complete, mark_complete, set_writable

    def stage(name, out_path, fn, incremental=False):
        if os.path.exists(out_path):
            if resume and is_complete(out_path):
                log(f"[pipeline] {name}: complete, skipping")
                return None
            import shutil

            if resume and incremental:
                # The stage's per-tint writes are atomic (and cluster
                # skips already-written tints), so a crashed run's
                # partial directory is salvageable: re-run IN PLACE
                # instead of discarding completed work.
                log(f"[pipeline] {name}: incomplete output, resuming in place")
                set_writable(out_path)
            else:
                # Snakemake semantics: a forced re-run -- or a resume
                # over a non-incremental stage that crashed mid-write
                # (no completion marker) -- removes the stale output
                # first (rules own their output paths; protected
                # outputs are made writable first).
                if resume:
                    log(f"[pipeline] {name}: incomplete output, re-running")
                set_writable(out_path)
                if os.path.isdir(out_path):
                    shutil.rmtree(out_path)
                else:
                    os.remove(out_path)
        metrics = StageMetrics(name)
        for attempt in range(cfg.retries + 1):
            try:
                result = fn()
                break
            except Exception:
                if attempt == cfg.retries:
                    raise
                log(f"[pipeline] {name}: attempt {attempt + 1} failed; retrying")
                # Clean slate for the retry unless the stage resumes
                # incrementally (atomic per-tint outputs survive).
                if not incremental and os.path.exists(out_path):
                    import shutil

                    set_writable(out_path)
                    if os.path.isdir(out_path):
                        shutil.rmtree(out_path)
                    else:
                        os.remove(out_path)
        mark_complete(out_path)
        if protect:
            from ..utils.fsio import protect_outputs

            protect_outputs(out_path)
        if isinstance(result, dict):
            metrics.add("tints", sum(result.values()))
        elif isinstance(result, int):
            metrics.add("tints", result)
        stats[name] = dict(**metrics.finish(), result=result)
        log(f"[pipeline] {name}: done in {stats[name]['seconds']:.2f}s "
            f"({result}) engine={stage_engine(name, cfg)}")
        return result

    # split demands fresh contig dirs (exist_ok=False, faithful to the
    # reference); segment overwrites atomically and cluster additionally
    # skips already-complete tints, so both resume in place.
    stage("split", split_dir, lambda: run_split(bam, reads, split_dir, cfg.split))
    stage("segment", segment_dir,
          lambda: run_segment(split_dir, segment_dir, cfg.segment, log=log),
          incremental=True)
    stage("cluster", cluster_dir,
          lambda: run_cluster(segment_dir, cluster_dir, cfg.cluster),
          incremental=True)
    stage(
        "isoforms",
        gtf_path,
        lambda: run_isoforms(split_dir, cluster_dir, gtf_path, cfg.isoforms),
    )
    stats["gtf"] = gtf_path
    return stats
