"""The generator: the same seed gives the same traffic on every call,
and every seed the same sizes in another order."""

import numpy as np

from benchmark import harness, traffic

SEED = 2 ** 31 + 12345


def _mix(name):
    return harness.traffic(name)


def test_packed_batches_repeat_per_seed_and_keep_the_packing_rules():
    mix = dict(_mix("packed-docs-8x2048"), batch=4, seq=256)
    mix["documents"] = dict(mix["documents"], median=64, max=256)
    a = traffic.packed_batches(mix, SEED, 3)
    b = traffic.packed_batches(mix, SEED, 3)
    assert a.shape == (3, 4, 256) and (a == b).all()
    assert not (a == traffic.packed_batches(mix, SEED + 1, 3)).all()
    rows = a.reshape(-1, 256)
    assert (rows[:, 0] == 0).all()
    assert (np.diff(rows, axis=1) >= 0).all()
    assert (np.diff(rows, axis=1) <= 1).all()


def test_pack_cuts_a_document_into_the_next_row():
    seg = traffic.pack([3, 6, 2], rows=2, seq=5)
    assert seg.tolist() == [[0, 0, 0, 1, 1], [0, 0, 0, 0, 1]]
    assert traffic.segment_lengths(seg[1]) == [4, 1]


def test_lengths_are_one_multiset_in_orders_drawn_from_the_seed():
    dist = _mix("packed-docs-8x2048")["documents"]
    a = traffic.lengths(dist, 300, SEED)
    b = traffic.lengths(dist, 300, SEED + 7)
    assert sorted(a) == sorted(b) and list(a) != list(b)
    assert (a == traffic.lengths(dist, 300, SEED)).all()
    assert a.min() >= dist["min"] and a.max() <= dist["max"]

