"""The byte counts behind the roofline shares, against hand counts on a
tiny graph, and the same bytes whatever the records' split into blocks
or launches."""

import pytest

import pprbench_cases  # noqa: F401
from pprbench import roofline

# a graph of 5 nodes, 3 of them with out-edges, 7 merged in-edges
N, N_OUT, M_IN = 5, 3, 7


def test_superstep_by_hand():
    # row pointers 6 x 4, threshold 5 x 4, ids and multiplicities 7 x 8,
    # the pushed values of 3 nodes x 2 columns x 4, the residue 5 x 2 x 8
    assert roofline.superstep_bytes(N, N_OUT, M_IN, 2) == \
        24 + 20 + 56 + 24 + 80


def test_index_level_by_hand():
    # 3 buckets' row pointers 3 x 6 x 4, inverse counts 3 x 4, 11 edges x
    # 8, the residue of 3 nodes x 2 x 4, the accumulator 5 x 2 x 4
    assert roofline.index_level_bytes(N, N_OUT, 11, 3, 2) == \
        72 + 12 + 88 + 24 + 40


def test_gather_bytes_over_records():
    recs = [{"level": 0, "delta": 0.1, "width": 2, "batches": 2,
             "supersteps": 3},
            {"level": 1, "delta": 0.01, "width": 2, "batches": 1,
             "supersteps": 1}]
    edges = [20, 15, 11, 9, 5, 3, 2, 1]
    depth = {0.1: 5, 0.01: 2}
    got = roofline.gather_bytes(recs, N, N_OUT, M_IN, edges,
                                lambda st: depth[st["delta"]])
    want = 4 * roofline.superstep_bytes(N, N_OUT, M_IN, 2) \
        + 2 * roofline.index_level_bytes(N, N_OUT, 3, 3, 2) \
        + roofline.index_level_bytes(N, N_OUT, 11, 6, 2)
    assert got == want
    # raw mode: no index, the pushes alone
    assert roofline.gather_bytes(recs, N, N_OUT, M_IN) == \
        4 * roofline.superstep_bytes(N, N_OUT, M_IN, 2)


def test_counts_do_not_depend_on_how_records_split():
    one = [{"supersteps": 6, "width": 4, "walks_total": 900}]
    two = [{"supersteps": 2, "width": 4, "walks_total": 400},
           {"supersteps": 4, "width": 4, "walks_total": 500}]
    assert roofline.gather_bytes(one, N, N_OUT, M_IN) == \
        roofline.gather_bytes(two, N, N_OUT, M_IN)
    assert roofline.walk_bytes(one, 0.2) == roofline.walk_bytes(two, 0.2)


def test_walk_bytes_by_hand():
    # start 4, first hop 12 taken with probability 0.8, endpoint 4 + 4
    assert roofline.walk_bytes([{"walks_total": 10}], 0.2) == \
        pytest.approx(10 * (4 + 9.6 + 8))


def test_share():
    name = "NVIDIA H100 80GB HBM3"
    assert roofline.share(3.35e12, 4.0, name) == pytest.approx(25.0)
    assert roofline.share(1e9, 0.0, name) is None
    assert roofline.share(0, 1.0, name) is None
    assert roofline.share(1e9, 1.0, "some other card") is None
