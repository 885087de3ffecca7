"""Unit tests for cluster-stage preprocessing and partitioning semantics
(py/freddie_cluster.py:175-344 equivalents)."""

import numpy as np

from freddie_jax.config import ClusterConfig
from freddie_jax.io.tsv import SegRead, SegTint
from freddie_jax.stages.cluster import (
    first_last_covered,
    informative_segs,
    partition_reads,
    preprocess,
    split_list_evenly,
)


def make_tint(rows, poly_tails=None, gaps=None, seg_len=100):
    """rows: list of data strings; one rep per distinct row."""
    M = len(rows[0])
    positions = [i * seg_len for i in range(M + 1)]
    reads = []
    reps = []
    for i, data in enumerate(rows):
        reads.append(
            SegRead(
                id=i, name=f"r{i}", chrom="c", strand="+", tint=0,
                data=[int(d) for d in data],
                gaps=dict(gaps[i]) if gaps else {},
                softclip={},
                poly_tail=dict(poly_tails[i]) if poly_tails else {},
            )
        )
        reps.append([i])
    return SegTint(
        id=0, chrom="c", positions=positions,
        segs=[(s, e, e - s) for s, e in zip(positions[:-1], positions[1:])],
        reads=reads, read_reps=reps,
    )


def test_first_last_covered():
    assert first_last_covered([0, 1, 0, 1, 0]) == (1, 3)
    assert first_last_covered([1, 1, 1]) == (0, 2)
    # reference quirk: no 1s -> (-1, M-1)
    assert first_last_covered([0, 0, 0]) == (-1, 2)


def test_preprocess_polya_promotion():
    # S-tail longer than 10 promotes FL start to 0 and adds a virtual gap
    tint = make_tint(
        ["01110", "01110"],
        poly_tails=[{"ST": (25, 4)}, {}],
    )
    ilp = preprocess(tint, ClusterConfig())
    assert tint.reads[0].poly_tail_category == "S"
    assert tint.reads[1].poly_tail_category == "N"
    assert ilp.gaps[0] == {(-1, 1): 4}
    # C row: correctable zeros within [FL]; with promotion min_i=0
    assert ilp.C[0].tolist() == [1, 0, 0, 0, 0]
    assert ilp.C[1].tolist() == [0, 0, 0, 0, 0]  # FL=(1,3): no zeros within
    assert ilp.FL[0] == (0, 3)
    assert ilp.FL[1] == (1, 3)


def test_preprocess_e_tail_and_short_tail_ignored():
    tint = make_tint(
        ["01100", "01100"],
        poly_tails=[{"EA": (30, 7)}, {"EA": (8, 7)}],  # second too short
    )
    ilp = preprocess(tint, ClusterConfig())
    assert tint.reads[0].poly_tail_category == "E"
    assert ilp.gaps[0] == {(2, 5): 7}
    assert ilp.FL[0] == (1, 4)
    assert tint.reads[1].poly_tail_category == "N"
    assert ilp.FL[1] == (1, 2)


def test_partition_compatibility_rule():
    # rows with <3 diffs over a >3 overlap are compatible (same partition);
    # rows sharing no exon are not
    tint = make_tint(
        [
            "111110",
            "110110",  # 1 diff vs row0 over overlap -> compatible
            "000001",  # no shared exon with row0/1 -> separate
            "000001",
        ]
    )
    ilp = preprocess(tint, ClusterConfig())
    parts = partition_reads(tint, ilp, max_ilp=1000)
    groups = [sorted(r) for r, _ in parts]
    assert [0, 1] in groups
    assert [2, 3] in groups


def test_partition_incompatible_pairs_recorded():
    # opposite tails -> incompatible even with matching data
    tint = make_tint(
        ["11110", "11110"],
        poly_tails=[{"ST": (25, 0)}, {"EA": (25, 0)}],
    )
    ilp = preprocess(tint, ClusterConfig())
    parts = partition_reads(tint, ilp, max_ilp=1000)
    # both singleton unique groups end in one component? no edge between
    # them; they become separate components
    all_rids = sorted(r for rids, _ in parts for r in rids)
    assert all_rids == [0, 1]
    for rids, incomp in parts:
        if len(rids) == 2:
            assert (0, 1) in incomp


def test_split_list_evenly():
    assert list(split_list_evenly(list(range(10)), 4)) == [
        [0, 1, 2, 3], [4, 5, 6, 7], [8, 9]
    ]
    assert list(split_list_evenly(list(range(4)), 1000)) == [[0, 1, 2, 3]]


def test_informative_segs():
    tint = make_tint(["01110", "01010"])
    ilp = preprocess(tint, ClusterConfig())
    inf = informative_segs(tint, ilp, [0, 1])
    # segment 2 varies across reads -> informative; ends always informative
    assert inf[0] and inf[4] and inf[2]
    # after removing read 1, segs 1-3 are constant 1; middle seg 2 equals
    # neighbors -> uninformative
    inf = informative_segs(tint, ilp, [0])
    assert inf == [True, True, False, True, True]
