"""Distributed-path tests: shard assignment, emulated multi-host merge,
and sharded DP solving on the 8-device CPU mesh."""

import os

import numpy as np

from freddie_jax.config import PipelineConfig
from freddie_jax.parallel.dist import merge_gtf_records, owns_tint, run_isoforms_distributed
from freddie_jax.stages.pipeline import run_pipeline
from freddie_jax.utils.sim import simulate


def test_owns_tint_partition_is_exact():
    # every tint owned by exactly one process, deterministic
    for pc in (1, 2, 4):
        for contig in ("chr1", "chr2"):
            for t in range(50):
                owners = [p for p in range(pc) if owns_tint(contig, t, p, pc)]
                assert len(owners) == 1


def test_emulated_multihost_isoforms_matches_single(tmp_path):
    sim = simulate(seed=31, n_genes=3, isoforms_per_gene=2, reads_per_isoform=8)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)
    out = str(tmp_path / "out")
    run_pipeline(bam, [fq], out, PipelineConfig(), log=lambda *a: None)
    single = open(os.path.join(out, "isoforms.gtf")).read()

    # Emulate 3 hosts: each produces its shard's records (the in-process
    # merge is a local sort when process_count()==1); the union of the
    # disjoint shards, sorted, must equal the single-process GTF.
    shard_records = [
        run_isoforms_distributed(
            os.path.join(out, "split"),
            os.path.join(out, "cluster"),
            str(tmp_path / f"shard_{pi}.gtf"),
            process_index=pi,
            process_count=3,
        )
        for pi in range(3)
    ]
    counts = [len(r) for r in shard_records]
    assert sum(counts) > 0
    merged = sorted(r for recs in shard_records for r in recs)
    text = "".join(t + "\n" for _k, t in merged)
    assert text == single


def test_sharded_dp_on_mesh_matches_host():
    import jax

    from freddie_jax.ops.segdp import DPProblem, solve_host
    from freddie_jax.ops.thresholds import ScaledThresholds
    from freddie_jax.parallel.mesh import loci_mesh, solve_batch_sharded

    assert len(jax.devices()) >= 8
    mesh = loci_mesh(8)
    thr = ScaledThresholds(0.9)
    rng = np.random.default_rng(3)
    B, P, R = 16, 12, 16
    C = np.zeros((B, P, R), np.int32)
    y = np.zeros((B, P), np.int32)
    W = np.ones((B, R), np.float32)
    n = np.full(B, P, np.int32)
    for b in range(B):
        inc = rng.integers(0, 10, size=(P, R))
        C[b] = np.cumsum(inc, axis=0)
        y[b] = np.sort(rng.choice(np.arange(2000), size=P, replace=False))
    K, bj, bk = solve_batch_sharded(
        C, y, W, n, 3, np.asarray(thr.lookup), thr.scale, mesh
    )
    K = np.asarray(K)
    bj = np.asarray(bj)
    bk = np.asarray(bk)
    for b in range(B):
        pr = DPProblem(
            C=C[b].astype(np.int64), y=y[b].astype(np.int64),
            W=W[b].astype(np.int64), read_support=3,
        )
        want = solve_host(pr, thr)
        j, k = int(bj[b]), int(bk[b])
        got = []
        if j >= 0:
            got = [j, k]
            while K[b, j, k] >= 0:
                k_ = int(K[b, j, k])
                got.append(k_)
                j, k = k, k_
        assert got == want


def test_sharded_chains_wide_weights_match_host():
    """The production multi-device call (return_chains=True: backpointers
    walked on device, shard-locally) with wide weights (97, past the
    7-bit range) must match the host oracle bit for bit on the
    8-virtual-device CPU mesh."""
    import jax

    from freddie_jax.ops.segdp import DPProblem, collect_batch_device, solve_host
    from freddie_jax.ops.thresholds import ScaledThresholds
    from freddie_jax.parallel.mesh import loci_mesh, solve_batch_sharded

    assert len(jax.devices()) >= 8
    mesh = loci_mesh(8)
    thr = ScaledThresholds(0.9)
    rng = np.random.default_rng(5)
    B, P, R = 16, 12, 16
    C = np.zeros((B, P, R), np.int32)
    y = np.zeros((B, P), np.int32)
    W = np.full((B, R), 97, np.float32)
    n = np.full(B, P, np.int32)
    for b in range(B):
        inc = rng.integers(0, 10, size=(P, R))
        C[b] = np.cumsum(inc, axis=0)
        y[b] = np.sort(rng.choice(np.arange(2000), size=P, replace=False))
    chains = solve_batch_sharded(
        C, y, W, n, 3, np.asarray(thr.lookup), thr.scale, mesh,
        return_chains=True,
    )
    assert chains.shape == (B, P + 2)
    got = collect_batch_device(chains, list(range(B)), [None] * B)
    want = [
        solve_host(DPProblem(C=C[b].astype(np.int64), y=y[b].astype(np.int64),
                             W=W[b].astype(np.int64), read_support=3), thr)
        for b in range(B)
    ]
    assert got == want
