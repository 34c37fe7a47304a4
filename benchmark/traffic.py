"""The one traffic generator: every mix in ``traffic/*.json`` is data
that these functions read.

Sizes come from a fixed multiset and the run's ``--seed`` draws their
order and the token ids and pixels: every seed does the same amount of
work, so runs on different seeds spread no more than runs on one seed.
A distribution of lengths is ``{"median", "sigma", "min", "max",
"sizes_seed"}``: lognormal around the median, rounded and clipped.
"""

from __future__ import annotations

import math

import numpy as np


def _rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the run's seed (any whole number)."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def lengths(dist: dict, count: int, seed: int, stream: int = 0) -> np.ndarray:
    """``count`` lengths of the fixed multiset that ``dist`` and its
    ``sizes_seed`` define, in an order drawn from ``seed``."""
    sizes = np.random.default_rng(dist["sizes_seed"]).lognormal(
        math.log(dist["median"]), dist["sigma"], size=count)
    sizes = np.clip(np.rint(sizes), dist["min"], dist["max"]).astype(np.int64)
    return _rng(seed, stream).permutation(sizes)


def pack(doc_lengths, rows: int, seq: int) -> np.ndarray:
    """Documents laid end to end into ``rows`` rows of ``seq`` tokens
    with no padding: (rows, seq) int32 segment ids, non-decreasing along
    each row and starting at 0 in each. A document cut at a row's end
    goes on as a new segment at the start of the next row."""
    seg = np.empty((rows, seq), dtype=np.int32)
    docs = iter(int(n) for n in doc_lengths)
    left = 0
    for r in range(rows):
        pos, segment = 0, 0
        while pos < seq:
            if left == 0:
                try:
                    left = next(docs)
                except StopIteration:
                    raise ValueError("too few documents to fill the rows")
            take = min(left, seq - pos)
            seg[r, pos:pos + take] = segment
            pos, left, segment = pos + take, left - take, segment + 1
    return seg


def segment_lengths(seg_row) -> list[int]:
    """The lengths of the segments of one row of segment ids."""
    _, counts = np.unique(np.asarray(seg_row), return_counts=True)
    return [int(c) for c in counts]


def packed_batches(mix: dict, seed: int, batches: int) -> np.ndarray:
    """(batches, batch, seq) segment ids of ``batches`` packed batches:
    enough documents for every row, drawn as :func:`lengths` says."""
    batch, seq = mix["batch"], mix["seq"]
    dist = mix["documents"]
    tokens = batches * batch * seq
    # Four times the median's share: the clipped lognormal's mean is
    # above its median, so these fill the rows many times over.
    count = 4 * tokens // dist["median"] + 16
    seg = pack(lengths(dist, count, seed), batches * batch, seq)
    return seg.reshape(batches, batch, seq)
