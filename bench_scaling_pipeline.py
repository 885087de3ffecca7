#!/usr/bin/env python3
"""Pipeline-level scaling efficiency: the locus-sharded stages (segment +
cluster + isoforms incl. the collective GTF merge) on 1 vs 2 vs 4 real
jax.distributed (Gloo) processes, each pinned to its own cores.

This is the production multi-host program (parallel/dist.py hash
sharding) measured end to end, strong scaling: the same corpus, one
"host" = a fixed pinned core set. Efficiency_n = T1 / (n * Tn) with the
SAME cores-per-host at every point. Unlike the virtual-device kernel
harness (bench_scaling.py), nothing here time-shares cores, so the
measured loss is sharding skew + dispatch + collective overhead --
exactly what the BASELINE >=0.85 target bounds.

Two measurements:
  * the legacy 2-host point at half-machine hosts (cores_per_host =
    n_cores/2), the headline `pipeline_scaling_efficiency`;
  * an efficiency CURVE at 1 core per host for n in {1, 2, 4} (a 4-core
    machine cannot host 4 multi-core processes), `curve` in the JSON.

Hot-vs-cold convention, quantified in the JSON: each worker runs the
sharded stages twice; `cold` walls include the first pass's one-time
per-process costs (XLA program loads, native-lib dlopens), `hot` walls
are the steady-state second pass (the production workflow runner
processes many samples per process, so hot is the headline and cold is
reported alongside).

Prints one JSON line:
  {"metric": "pipeline_scaling_efficiency", "value": eff_hot,
   "t1_s": ..., "t2_s": ..., "hosts": 2, "cores_per_host": K,
   "cold": {...}, "curve": {"cores_per_host": 1, "hosts": [1, 2, 4],
   "hot_s": [...], "efficiency": [...], "cold_s": [...]}}
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import textwrap

REPO = os.path.dirname(os.path.abspath(__file__))

WORKER = textwrap.dedent(
    """
    import json, os, sys, time
    os.environ["JAX_PLATFORMS"] = "cpu"
    repo, corpus, outdir, pid, nprocs, port, threads = (
        sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4]),
        int(sys.argv[5]), sys.argv[6], int(sys.argv[7]))
    sys.path.insert(0, repo)
    import jax
    jax.config.update("jax_platforms", "cpu")
    if nprocs > 1:
        jax.distributed.initialize(
            coordinator_address=f"localhost:{port}",
            num_processes=nprocs, process_id=pid)
    import dataclasses
    from freddie_jax.config import PipelineConfig
    from freddie_jax.parallel.dist import (
        run_isoforms_distributed, owns_tint)
    from freddie_jax.stages.cluster import run_cluster
    from freddie_jax.stages.segment import run_segment

    cfg = PipelineConfig()
    cfg = dataclasses.replace(
        cfg,
        segment=dataclasses.replace(cfg.segment, threads=threads),
        cluster=dataclasses.replace(cfg.cluster, threads=threads),
        isoforms=dataclasses.replace(cfg.isoforms, threads=threads),
    )
    owns = lambda contig, tid: owns_tint(contig, tid, pid, nprocs)

    def full(out):
        run_segment(os.path.join(corpus, "split"),
                    os.path.join(out, "segment"), cfg.segment, owns=owns)
        run_cluster(os.path.join(out, "segment"),
                    os.path.join(out, "cluster"), cfg.cluster, owns=owns)
        run_isoforms_distributed(
            os.path.join(corpus, "split"), os.path.join(out, "cluster"),
            os.path.join(out, "isoforms.gtf"), cfg.isoforms,
            process_index=pid, process_count=nprocs)

    # Warm pass: per-process XLA program loads / native-lib builds are
    # one-time per-process costs; the production workflow runner
    # processes many samples per process, so steady-state (hot) walls
    # are what scale with hosts (same convention as bench.py's
    # segment_hot_s headline). The warm pass is timed too and reported
    # as the COLD wall, quantifying the convention. Per-pid dir: warm
    # isolation only.
    t0 = time.perf_counter()
    full(outdir + f"_warm{pid}")
    cold = time.perf_counter() - t0
    if nprocs > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices("bench-hot-start")
    t0 = time.perf_counter()
    full(outdir)
    print(json.dumps({"pid": pid, "wall": time.perf_counter() - t0,
                      "cold": cold}))
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(nprocs: int, corpus: str, outdir: str, cores_per: int,
                 script: str) -> tuple:
    """Returns (max hot wall, max cold wall) across the nprocs workers."""
    port = _free_port()
    procs = []
    for pid in range(nprocs):
        lo = pid * cores_per
        cores = ",".join(str(c) for c in range(lo, lo + cores_per))
        procs.append(
            subprocess.Popen(
                ["taskset", "-c", cores, sys.executable, script, REPO,
                 corpus, outdir, str(pid), str(nprocs), str(port),
                 str(cores_per)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
        )
    walls, colds = [], []
    for p in procs:
        out, err = p.communicate(timeout=1800)
        if p.returncode != 0:
            raise RuntimeError(f"worker failed: {err[-2000:]}")
        for line in out.splitlines():
            line = line.strip()
            if line.startswith("{"):
                rec = json.loads(line)
                walls.append(rec["wall"])
                colds.append(rec["cold"])
    return max(walls), max(colds)


def main():
    n_cores = os.cpu_count() or 4
    cores_per = max(n_cores // 2, 1)
    workdir = tempfile.mkdtemp(prefix="freddie_scale_")
    script = os.path.join(workdir, "worker.py")
    with open(script, "w") as f:
        f.write(WORKER)
    try:
        # Corpus: the bench dataset (96 uniform loci) split once, untimed.
        sys.path.insert(0, REPO)
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
        import bench as bench_mod

        corpus = os.path.join(workdir, "corpus")
        os.makedirs(corpus)
        bam, fq, n_reads, _truth, _r = bench_mod.build_dataset(corpus)
        from freddie_jax.config import SplitConfig
        from freddie_jax.stages.split import run_split

        run_split(bam, [fq], os.path.join(corpus, "split"),
                  SplitConfig(threads=n_cores))

        def best(n, cores, tag):
            runs = [
                _run_workers(n, corpus, os.path.join(workdir, f"{tag}{i}"),
                             cores, script)
                for i in range(2)
            ]
            return (min(h for h, _ in runs), min(c for _, c in runs))

        t1, t1c = best(1, cores_per, "one")
        t2, t2c = best(2, cores_per, "two")
        eff = t1 / (2 * t2)

        # Efficiency curve at 1 core per host (the only cores-per-host at
        # which this machine can run a 4-host point).
        curve_hosts = [n for n in (1, 2, 4) if n <= n_cores]
        curve_hot, curve_cold = [], []
        for n in curve_hosts:
            h, c = best(n, 1, f"c{n}_")
            curve_hot.append(round(h, 2))
            curve_cold.append(round(c, 2))
        curve_eff = [
            round(curve_hot[0] / (n * h), 3)
            for n, h in zip(curve_hosts, curve_hot)
        ]
        print(json.dumps(dict(
            metric="pipeline_scaling_efficiency",
            value=round(eff, 3), unit="fraction", hosts=2,
            cores_per_host=cores_per, t1_s=round(t1, 2), t2_s=round(t2, 2),
            reads=n_reads,
            cold=dict(t1_s=round(t1c, 2), t2_s=round(t2c, 2),
                      efficiency=round(t1c / (2 * t2c), 3)),
            curve=dict(cores_per_host=1, hosts=curve_hosts,
                       hot_s=curve_hot, efficiency=curve_eff,
                       cold_s=curve_cold),
        )))
        print(
            f"[pipe-scaling] 1 host {t1:.2f}s vs 2 hosts {t2:.2f}s "
            f"({cores_per} cores/host) -> efficiency {eff:.3f}; "
            f"1-core curve hosts={curve_hosts} hot={curve_hot} "
            f"eff={curve_eff}",
            file=sys.stderr,
        )
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
