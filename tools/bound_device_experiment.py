#!/usr/bin/env python3
"""Host-vs-device crossover for cluster optimistic-bound evaluation.

The cluster solver's only dense per-instance math is the optimistic bound
over candidate structures: for masks E and reads i,
    subset_ok = (I_i & ~E) == 0,  d = g_i - popcount(C_i & E),
    bound(E)  = g_total - sum_i max(d, 0) over subset-ok reads
-- two (N, Mi) x (Mi, K) matmuls on a device (0/1 operands are exact
even when the default f32 dot runs in TF32, and the f32 sums are exact;
all sums are multiples of 0.5 far below 2^23, so device f32 equals host
f64 bit-for-bit).

This tool measures both engines across an (N, K) grid and reports the
crossover, which sets the solver's device gate (solver/segenum.py
BOUNDS_DEVICE_MIN): after the reference's partitioning caps (N <= 1000
unique reads, py/freddie_cluster.py:71-79) real closures hold 10^2..10^4
masks. Values are asserted identical between engines. On a GPU machine
the default backend is the card; it fails when JAX finds no GPU unless
--backend cpu asks for the host backend.

Usage: python tools/bound_device_experiment.py [--backend cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402


def host_bounds(I_int, C_int, g, masks):
    g_total = g.sum()
    out = np.empty(len(masks), dtype=np.float64)
    BLK = 1 << 12
    for lo in range(0, len(masks), BLK):
        E = masks[lo : lo + BLK]
        subset_ok = (I_int[:, None] & ~E[None, :]) == 0
        d = g[:, None] - np.bitwise_count(
            C_int[:, None] & E[None, :]
        ).astype(np.float64)
        out[lo : lo + len(E)] = g_total - np.where(
            subset_ok & (d > 0), d, 0.0
        ).sum(axis=0)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default=None)
    args = ap.parse_args()

    import jax

    if args.backend:
        jax.config.update("jax_platforms", args.backend)
    elif jax.devices()[0].platform != "gpu":
        raise SystemExit(f"no GPU found (devices: {jax.devices()}); "
                         "pass --backend cpu to measure the host backend")
    import jax.numpy as jnp

    from freddie_jax.utils.procenv import use_compile_cache

    use_compile_cache()

    Mi = 64

    @jax.jit
    def device_bounds(I_f, C_f, g, E_f):
        # I_f/C_f: (N, Mi) f32 0/1; E_f: (K, Mi) f32 0/1.
        viol = I_f @ (1.0 - E_f).T  # (N, K): popcount(I & ~E)
        corr = C_f @ E_f.T  # (N, K): popcount(C & E)
        d = g[:, None] - corr
        pos = jnp.where((viol == 0) & (d > 0), d, 0.0)
        return g.sum() - pos.sum(axis=0)

    rng = np.random.default_rng(0)
    rows = []
    for N in (100, 250, 1000):
        for K in (1_000, 4_000, 20_000, 100_000, 500_000):
            I_bits = rng.random((N, Mi)) < 0.3
            C_bits = (~I_bits) & (rng.random((N, Mi)) < 0.3)
            g = (rng.integers(1, 5, N) * 3).astype(np.float64)
            masks = np.unique(
                rng.integers(0, 1 << 63, K, dtype=np.int64).astype(np.uint64)
            )[:K]
            E_bits = (
                (masks[:, None] >> np.arange(Mi, dtype=np.uint64)[None, :]) & 1
            ).astype(np.float32)

            def pack(bits):
                padded = np.zeros((len(bits), 64), dtype=bool)
                padded[:, :Mi] = bits
                return (
                    np.packbits(padded, axis=1, bitorder="little")
                    .view(np.uint64)
                    .ravel()
                )

            I_int, C_int = pack(I_bits), pack(C_bits)
            t0 = time.perf_counter()
            want = host_bounds(I_int, C_int, g, masks)
            host_s = time.perf_counter() - t0

            I_f = jnp.asarray(I_bits, jnp.float32)
            C_f = jnp.asarray(C_bits, jnp.float32)
            g_j = jnp.asarray(g, jnp.float32)
            E_j = jnp.asarray(E_bits)
            got = np.asarray(device_bounds(I_f, C_f, g_j, E_j))  # compile+run
            ts = []
            for _ in range(3):
                t0 = time.perf_counter()
                got = np.asarray(device_bounds(I_f, C_f, g_j, E_j))
                ts.append(time.perf_counter() - t0)
            dev_s = min(ts)
            assert np.array_equal(got.astype(np.float64), want), (
                "device bounds differ from host"
            )
            rows.append(
                dict(N=N, K=len(masks), host_ms=round(host_s * 1e3, 2),
                     device_ms=round(dev_s * 1e3, 2),
                     winner="device" if dev_s < host_s else "host")
            )
            print(rows[-1], flush=True)
    dev = jax.devices()[0]
    print(json.dumps(dict(backend=dev.platform, device_kind=dev.device_kind,
                          grid=rows)))


if __name__ == "__main__":
    main()
