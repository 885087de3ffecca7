"""Process environment: JAX's persistent compile cache, and the
environment of spawned CPU-only worker pools.

The cluster/isoforms stages fan per-tint work over spawn process pools
(reproducing the reference's multiprocessing.Pool parallelism,
py/freddie_cluster.py:797-814, py/freddie_isoforms.py:274). Workers are
CPU-only by design: a JAX process reserves most of an accelerator's
memory when it first touches it, so only the parent may use the device.
``cpu_worker_env`` pins any JAX import in a worker to the host CPU
backend.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def use_compile_cache() -> None:
    """Keep JAX's persistent compilation cache at <checkout>/.jax_cache
    unless JAX_COMPILATION_CACHE_DIR names another place (JAX reads that
    variable itself, so then nothing is set here). The path is part of
    the cache key, so it is fixed rather than per-run."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update(
        "jax_compilation_cache_dir", os.path.join(CHECKOUT, ".jax_cache")
    )


@contextmanager
def cpu_worker_env():
    """Scope os.environ so spawned children boot as plain CPU workers.

    Spawn reads the parent's environment at child launch, so this must
    wrap the pool's whole lifetime (workers launch lazily on submit). The
    parent's JAX_PLATFORMS is restored on exit. Not thread-safe against a
    concurrent process launch from another thread -- the stages run their
    pools sequentially.
    """
    saved_platforms = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        yield
    finally:
        if saved_platforms is None:
            os.environ.pop("JAX_PLATFORMS", None)
        else:
            os.environ["JAX_PLATFORMS"] = saved_platforms
