"""freddie-jax: an isoform detection/discovery engine in JAX.

A brand-new implementation of the capabilities of vpc-ccg/freddie
(annotation-free transcriptomic isoform discovery from splice-aligned
Nanopore long reads), built to run its dense work on an NVIDIA GPU:

- Host side: streaming BAM/FASTQ ingest (own BGZF/BAM codec; the reference
  delegates this to pysam/htslib), locus partitioning, wire formats, and
  native C/C++ engines for the per-tint work of every stage.
- Device side: the segmentation breakpoint DP, the cumulative-coverage
  build, the polyA scans and the cluster solver's wide-path bounds run as
  batched XLA programs over thousands of loci, with integer-exact decision
  thresholds so results are bit-identical across CPU and GPU backends.
- The reference's Gurobi ILP (py/freddie_cluster.py:347-636) is replaced by
  a deterministic exact branch-and-bound solver (freddie_jax.solver).

Pipeline stages (mirroring the reference's 4 CLI stages):
  split    -> independent transcriptional intervals ("tints") from BAM
  segment  -> canonical segmentation per tint + per-read 0/1/2 matrices
  cluster  -> exact read->isoform assignment
  isoforms -> consensus + boundary correction -> GTF
"""

__version__ = "0.1.0"

__all__ = ["run_pipeline", "PipelineConfig"]


def __getattr__(name):
    # Lazy convenience exports (keep bare `import freddie_jax` light).
    if name == "run_pipeline":
        from .stages.pipeline import run_pipeline

        return run_pipeline
    if name == "PipelineConfig":
        from .config import PipelineConfig

        return PipelineConfig
    raise AttributeError(name)
