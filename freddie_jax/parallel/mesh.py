"""Loci-mesh construction and sharded DP solving.

The production segment stage routes phase B through solve_batch_sharded
whenever more than one local device is attached (ops.segdp.
solve_batch_device), so a multi-chip host is used by a single process
without operator intervention; results are bit-identical to the
single-device launch (tests/test_dist.py, test_segment_sharded).
"""

from __future__ import annotations

import numpy as np

_mesh_cache: dict = {}
_fn_cache: dict = {}


def loci_mesh(n_devices: int | None = None, local: bool = False):
    """A 1-D mesh over available devices with a single 'loci' axis.

    local=True restricts to this process's devices (the production
    segment-stage dispatch: in a multi-host run each process owns its
    locus shard and must not shard batches over other hosts' devices).
    Cached per device tuple: pjit compilation caches key on the mesh
    object, so callers must receive the same Mesh across dispatches.
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.local_devices() if local else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    key = tuple(id(d) for d in devices)
    mesh = _mesh_cache.get(key)
    if mesh is None:
        mesh = Mesh(np.array(devices), ("loci",))
        _mesh_cache[key] = mesh
    return mesh


def _sharded_solver(mesh, read_support: int, scale: int,
                    return_chains: bool = False):
    """Jitted batch-sharded DP solver, cached per (mesh, read_support,
    scale, return_chains) so repeated dispatches reuse the compiled
    executable. The XLA partitioner splits the batch dim over 'loci'."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.segdp import _solve_batch_jax, _walk_chains

    key = (mesh, read_support, scale, return_chains)
    fn = _fn_cache.get(key)
    if fn is None:
        batch_sh = NamedSharding(mesh, P("loci"))
        repl = NamedSharding(mesh, P())

        def kernel(C, y, W, n_cand, lookup):
            out = _solve_batch_jax(
                C.astype("int32"), y, W, n_cand, read_support, lookup, scale,
            )
            return _walk_chains(*out) if return_chains else out

        fn = jax.jit(
            kernel,
            in_shardings=(batch_sh, batch_sh, batch_sh, batch_sh, repl),
            out_shardings=batch_sh if return_chains
            else (batch_sh, batch_sh, batch_sh),
        )
        _fn_cache[key] = fn
    return fn


def solve_batch_sharded(C, y, W, n_cand, read_support, lookup, scale, mesh,
                        return_chains: bool = False):
    """Run the batched segmentation DP with the batch dim sharded over the
    mesh's 'loci' axis. The batch size must be a multiple of the mesh size
    (callers pad with dummy problems). return_chains=True walks the
    backpointers on device and returns (B, P+2) -1-terminated chains
    instead of (K, best_j, best_k) -- the production dispatch path."""
    import jax.numpy as jnp

    fn = _sharded_solver(mesh, read_support, scale,
                         return_chains=return_chains)
    return fn(
        jnp.asarray(C),
        jnp.asarray(y),
        jnp.asarray(W),
        jnp.asarray(n_cand),
        jnp.asarray(lookup),
    )
