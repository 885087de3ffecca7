"""True multi-process collective test: two jax.distributed CPU processes
all-gather and merge GTF records identically."""

import os
import socket
import subprocess
import sys
import textwrap


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_merge(tmp_path):
    port = _free_port()
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
            sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
            from freddie_jax.parallel.dist import merge_gtf_records
            local = [(("chr1", 10 + pid),
                      f"chr1\\tx\\ttranscript\\t{{11 + pid}}\\t100\\t.\\t+\\t.\\tp{{pid}}")]
            merged = merge_gtf_records(local)
            assert len(merged) == 2, merged
            assert merged[0][1].endswith("p0") and merged[1][1].endswith("p1")
            print(f"OK{{pid}}")
            """
        )
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=90) for p in procs]
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (i, out, err)
        assert f"OK{i}" in out
