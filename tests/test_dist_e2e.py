"""GENUINELY concurrent distributed pipeline test: two jax.distributed
(Gloo/CPU) processes run run_pipeline_distributed end-to-end on a shared
filesystem -- exercising the split-once-by-p0 handoff, the
sync_global_devices barrier, shard-owned segment/cluster, and the
all-gather GTF merge under real concurrency -- and the merged GTF plus
every shard TSV must be byte-identical to a single-process run."""

import filecmp
import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _walk(root):
    out = {}
    for r, _d, fns in os.walk(root):
        for fn in fns:
            if fn.startswith("."):  # completion markers are infrastructure
                continue
            p = os.path.join(r, fn)
            out[os.path.relpath(p, root)] = p
    return out


def test_two_process_pipeline_end_to_end(tmp_path):
    sys.path.insert(0, REPO)
    from freddie_jax.parallel.dist import owns_tint
    from freddie_jax.utils.sim import simulate

    # the 4 simulated tints must split across both processes for the test
    # to exercise genuine shard-owned work on each side
    owners = {p for t in range(4) for p in range(2) if owns_tint("chr1", t, p, 2)}
    assert owners == {0, 1}

    sim = simulate(seed=29, n_genes=4, isoforms_per_gene=2, reads_per_isoform=8,
                   minus_strand_genes=True, truncate_prob=0.2, tail_prob=0.8)
    bam, fq = str(tmp_path / "r.bam"), str(tmp_path / "r.fastq")
    sim.write_bam(bam)
    sim.write_fastq(fq)

    port = _free_port()
    dist_out = str(tmp_path / "dist")
    script = tmp_path / "worker.py"
    script.write_text(
        textwrap.dedent(
            f"""
            import os, sys
            os.environ["JAX_PLATFORMS"] = "cpu"
            import jax
            jax.config.update("jax_platforms", "cpu")
            pid = int(sys.argv[1])
            jax.distributed.initialize(
                coordinator_address="localhost:{port}",
                num_processes=2, process_id=pid,
            )
            sys.path.insert(0, {REPO!r})
            from freddie_jax.parallel.dist import run_pipeline_distributed
            merged = run_pipeline_distributed(
                {bam!r}, [{fq!r}], {dist_out!r}, log=lambda *a: None,
            )
            print(f"RECORDS{{pid}}={{len(merged)}}")
            """
        )
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (i, out[-2000:], err[-2000:])
    # both processes saw the same merged record count
    counts = sorted(line for out, _ in outs for line in out.splitlines()
                    if line.startswith("RECORDS"))
    assert len(counts) == 2
    assert counts[0].split("=")[1] == counts[1].split("=")[1]

    # single-process reference run
    from freddie_jax.config import PipelineConfig
    from freddie_jax.stages.pipeline import run_pipeline

    single_out = str(tmp_path / "single")
    run_pipeline(bam, [fq], single_out, PipelineConfig(), log=lambda *a: None)

    # merged GTF byte-identical
    with open(os.path.join(dist_out, "isoforms.gtf")) as f:
        dist_gtf = f.read()
    with open(os.path.join(single_out, "isoforms.gtf")) as f:
        single_gtf = f.read()
    assert dist_gtf == single_gtf
    assert dist_gtf.count("\ttranscript\t") >= 4

    # every shard TSV (segment + cluster) byte-identical to single-process;
    # the union of the two shards covers every tint exactly once.
    for stage in ("segment", "cluster"):
        dist_files = _walk(os.path.join(dist_out, stage))
        single_files = _walk(os.path.join(single_out, stage))
        assert sorted(dist_files) == sorted(single_files), stage
        for rel in single_files:
            assert filecmp.cmp(dist_files[rel], single_files[rel], shallow=False), (
                stage, rel,
            )
