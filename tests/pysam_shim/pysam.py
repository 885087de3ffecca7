"""Minimal pysam-compatible shim backed by freddie_jax's own BAM codec.

Lets the *reference* scripts (which import pysam) run in this image so
their outputs can be byte-compared against ours
(tests/test_reference_parity.py). Only the surface the reference uses is
provided: AlignmentFile(path, 'rb').header['SQ'], .fetch(contig=...), the
record attributes read by py/freddie_split.py, and the CIGAR op constants.
"""

from freddie_jax.io.bam import (  # noqa: F401
    CDEL,
    CDIFF,
    CEQUAL,
    CHARD_CLIP,
    CINS,
    CMATCH,
    CPAD,
    CREF_SKIP,
    CSOFT_CLIP,
)
from freddie_jax.io.bam import BamReader as _BamReader

CBACK = 9


class AlignmentFile:
    def __init__(self, path, mode="rb"):
        self._path = path
        r = _BamReader(path)
        self.header = {
            "SQ": [
                {"SN": n, "LN": l}
                for n, l in zip(r.references, r.lengths)
            ]
        }
        r.close()

    def fetch(self, contig=None):
        r = _BamReader(self._path)
        try:
            for rec in r:
                if contig is not None and rec.reference_name != contig:
                    continue
                yield rec
        finally:
            r.close()
