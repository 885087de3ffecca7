"""Length-adaptive coverage thresholds, in exact integer arithmetic.

The reference tabulates a logistic ramp of the high threshold by segment
length (py/freddie_segment.py:277-286, values rounded to 2 decimals) and
compares coverage ratios against it in float64:

    c = (C[j] - C[i]) / seg_len            # rational with small denominator
    yea = c > h ;  nay = c < 1 - h         # h = table[seg_len] or rate

Because h is an exact multiple of 1/SCALE and the ratio c is a rational
whose denominator is bounded by the segment length, the float comparisons
are *exactly* equivalent to integer comparisons -- with one wrinkle on the
nay side. The reference's ``h`` is fl(decimal) and ``c`` is a correctly
rounded quotient, so when c equals the decimal exactly both floats are the
same double and ``c > h`` is False, matching strict integer ``>``. But the
reference derives ``l = 1 - h`` in float64 arithmetic, and fl(1 - fl(h))
can land one ulp ABOVE the exact decimal 1-h (e.g. h=0.7: 1-0.7 =
0.30000000000000004), in which case a ratio exactly equal to 1-h satisfies
``c < l`` in the reference. Whether the equality case counts as nay is
therefore a fixed per-entry bit:

    eq_nay = (1.0 - fl(h)) > fl((SCALE - h_scaled)/SCALE)

and the exact integer comparisons are

    yea:  SCALE*(C[j]-C[i]) > h_scaled * seg_len
    nay:  SCALE*(C[j]-C[i]) < (SCALE - h_scaled) * seg_len + eq_nay

(for non-equal ratios the gap to the threshold is at least
1/(SCALE*seg_len), far above any float64 rounding of the division, so
strict comparisons agree). We therefore carry thresholds as integers with
the eq bit packed into the low bit of ``lookup`` (value = h_scaled*2 +
eq_nay), which makes the decision bit-identical across float32 device
kernels, float64 host math, and the reference
(py/freddie_segment.py:485-497 for the DP, :815-828 for genotyping).
"""

from __future__ import annotations

from math import exp

import numpy as np


def smooth_threshold_table(threshold: float) -> list[float]:
    """The reference's logistic threshold ramp (py/freddie_segment.py:277-286).

    Entry x is the high threshold for a segment of length x, rounded to two
    decimals; the table stops once x*(threshold - y) < 0.5 (and x > 5)."""
    vals: list[float] = []
    while True:
        x = len(vals)
        y = threshold / (1 + ((threshold - 0.5) / 0.5) * exp(-0.05 * x))
        if x > 5 and x * (threshold - y) < 0.5:
            break
        vals.append(round(y, 2))
        assert len(vals) < 1000
    return vals


class ScaledThresholds:
    """Integer-scaled threshold lookup.

    ``table_scaled[L]`` is the high threshold (times SCALE) for segment
    length L < len(table); longer segments use ``rate_scaled``.
    """

    def __init__(self, threshold_rate: float):
        self.rate = threshold_rate
        table = smooth_threshold_table(threshold_rate)
        # Table entries are exact multiples of 1/100 by construction.
        # The rate itself usually is too (default 0.9); find a scale that
        # represents both exactly.
        for scale in (100, 1000, 10_000, 100_000):
            r = threshold_rate * scale
            if abs(r - round(r)) < 1e-6:
                self.scale = scale
                break
        else:
            raise ValueError(
                f"threshold_rate={threshold_rate} is not an exact decimal; "
                "use at most 5 decimal places"
            )
        self.rate_scaled = int(round(threshold_rate * self.scale))
        self.table_scaled = np.array(
            [int(round(v * self.scale)) for v in table], dtype=np.int64
        )
        # Per-entry equality bit for the nay side: does the reference's
        # float l = 1 - h sit above the exact decimal 1-h? If so a ratio
        # exactly equal to 1-h counts as nay (see module docstring). The
        # reference floats are the table values from round(y, 2) / the raw
        # rate, both == fl(scaled/scale) by correct rounding of division.
        unpacked = np.concatenate([self.table_scaled, [self.rate_scaled]])
        self.eq_nay = np.array(
            [
                1 if (1.0 - hs / self.scale) > (self.scale - hs) / self.scale else 0
                for hs in unpacked.tolist()
            ],
            dtype=np.int32,
        )
        # Lookup array with the rate appended as the "beyond table" entry
        # (index with min(seg_len, len(table))), the eq bit packed into the
        # low bit so one array carries both through kernel signatures:
        # h_scaled = lookup >> 1, eq_nay = lookup & 1.
        self.lookup = (unpacked.astype(np.int32) << 1) | self.eq_nay

    def high_scaled(self, seg_len: np.ndarray) -> np.ndarray:
        """Vectorized high threshold (times SCALE) by segment length."""
        idx = np.minimum(seg_len, len(self.table_scaled))
        return self.lookup[idx] >> 1

    def nay_eq_scaled(self, seg_len: np.ndarray) -> np.ndarray:
        """Vectorized 0/1: whether a ratio exactly at 1-h counts as nay."""
        idx = np.minimum(seg_len, len(self.table_scaled))
        return self.lookup[idx] & 1
