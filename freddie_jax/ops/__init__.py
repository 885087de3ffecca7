"""Compute kernels: batched, statically-shaped, integer-exact.

Every decision threshold that the reference evaluates in floating point on
coverage ratios is evaluated here on scaled integers (see
freddie_jax.ops.thresholds), which makes results bit-identical between the
host oracle (numpy) and the batched device kernels (XLA),
and between float32 device math and float64 host math.
"""
