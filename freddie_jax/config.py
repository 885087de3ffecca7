"""Per-stage configuration dataclasses.

Defaults match the reference CLIs exactly:
  split:    /root/reference/py/freddie_split.py:16-52
  segment:  /root/reference/py/freddie_segment.py:53-110
  cluster:  /root/reference/py/freddie_cluster.py:37-110
  isoforms: /root/reference/py/freddie_isoforms.py:10-47
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SplitConfig:
    # Consider reads with no splicing (single exonic interval).
    consider_nonspliced: bool = False
    # Contigs shorter than this are skipped entirely.
    contig_min_size: int = 1_000_000
    # Deletions (CIGAR D) longer than this are treated as introns (CIGAR N).
    max_del_size: int = 20
    # A tint group needs at least this many reads to be kept.
    min_reads_per_tint: int = 3
    # Oversized-tint caps: a tint with >= these is broken on weak junctions.
    max_tint_intervals: int = 100
    max_tint_reads: int = 1500
    threads: int = 1


@dataclass(frozen=True)
class SegmentConfig:
    # Consider the start/end splice sites of each read in the signal.
    consider_ends: bool = False
    # Gaussian smoothing sigma for the splice signal.
    sigma: float = 5.0
    # Coverage ratio above which a read covers a segment (low = 1-rate).
    threshold_rate: float = 0.90
    # Fixed-candidate threshold: mean + variance_factor*std of nonzero signal.
    variance_factor: float = 3.0
    # Max candidate breakpoints per DP problem.
    max_problem_size: int = 50
    # Min weighted read support for a breakpoint ("outside" gate).
    min_read_support_outside: int = 3
    threads: int = 1
    # Run the batched segmentation DP on an accelerator (XLA) instead of the
    # host oracle. Results are bit-identical; this is a performance switch.
    use_device: bool = True
    validate: bool = False
    # Streaming-window knob for 100M-scale corpora: every `stream_window`
    # tints prepared, force-flush every partially-filled dispatch bucket
    # (padded to the bucket's standard power-of-two batch shape, so no
    # fresh kernel compiles). Without it, one problem parked in a rare
    # (P, R) bucket can hold its tint -- and, because tints drain in
    # order, every LATER tint's parsed capsule -- resident until the end
    # of phase A. 0 = off (the default; the right setting for corpora
    # that fit comfortably in memory, since fuller chunks amortize launch
    # overhead better). Outputs are byte-identical either way: chunk
    # composition never affects per-problem DP solutions.
    stream_window: int = 0

    def __post_init__(self):
        assert 1 >= self.threshold_rate >= 0.5
        assert 10 > self.variance_factor > 0
        assert 50 >= self.sigma > 0
        assert self.max_problem_size > 3
        assert self.min_read_support_outside >= 0


@dataclass(frozen=True)
class ClusterConfig:
    # Garbage (recycle) cost model: constant | exons | introns | relative.
    recycle_model: str = "constant"
    # Slack +- value for exons and the unaligned gaps.
    gap_offset: int = 20
    # Epsilon percent value for how much unaligned gaps can cover.
    epsilon: float = 0.2
    # Max isoform-peeling rounds per partition.
    max_rounds: int = 30
    # Min number of supporting reads for an isoform.
    min_isoform_size: int = 3
    # Max unique reads per solver instance; larger partitions are split evenly.
    max_ilp: int = 1000
    # Solver deadline in minutes per instance (reference: Gurobi TimeLimit).
    timeout: float = 1.0
    # Number of isoforms per round (garbage + K-1 real). Reference pins K=2.
    K: int = 2
    threads: int = 1
    logs_dir: str | None = None

    def __post_init__(self):
        assert self.recycle_model in ("constant", "exons", "introns", "relative")
        assert self.gap_offset >= 0
        assert self.epsilon >= 0
        assert self.timeout > 0
        assert self.min_isoform_size >= 0
        assert self.max_rounds >= 0


@dataclass(frozen=True)
class IsoformsConfig:
    # Majority threshold of reads to adjust exon boundaries.
    majority_threshold: float = 0.50
    # +/- window around segment boundaries for correction (0 = off).
    correction_window: int = 8
    threads: int = 1

    def __post_init__(self):
        assert 0.5 <= self.majority_threshold <= 1.0
        assert 0 <= self.correction_window <= 20


@dataclass(frozen=True)
class PipelineConfig:
    split: SplitConfig = dataclasses.field(default_factory=SplitConfig)
    segment: SegmentConfig = dataclasses.field(default_factory=SegmentConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    isoforms: IsoformsConfig = dataclasses.field(default_factory=IsoformsConfig)
    # Per-stage retry budget (the Snakemake scheduler's rule-retry
    # analog): a stage raising an exception is cleaned up and re-run up
    # to this many extra times before the pipeline fails. Transient
    # faults (OOM-killed worker pools, device hiccups) pass;
    # deterministic bugs still fail fast with the last traceback.
    retries: int = 0

    @staticmethod
    def from_yaml(path: str) -> "PipelineConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        kwargs = {}
        for name, cls in (
            ("split", SplitConfig),
            ("segment", SegmentConfig),
            ("cluster", ClusterConfig),
            ("isoforms", IsoformsConfig),
        ):
            section = raw.get(name, {}) or {}
            fields = {f.name for f in dataclasses.fields(cls)}
            unknown = set(section) - fields
            if unknown:
                raise ValueError(f"unknown {name} config keys: {sorted(unknown)}")
            kwargs[name] = cls(**section)
        return PipelineConfig(**kwargs)
