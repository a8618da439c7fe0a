"""Index and query words that reach every branch of the join's lookups
(ops/join.py: the bucket table and the prefix window), for the tests of
their kernels (csrc/join.cu) and chip_smoke.py: one copy of the data,
made from a seeded numpy Generator.  Words are uint64, sorted where they
form an index; ops/kmers.keys_from_words_np makes them keys.
"""

from __future__ import annotations

import numpy as np

ALL_ONES = np.uint64(2**64 - 1)     # the index's sentinel word
# words at the edges of the key encoding: near 0, across the sign flip
# (2^63), and near 2^64 - 1, where t = 2^32 - 1 maps to v = 2^32 (the
# CDF map's clamped edge)
EDGES = np.array([0, 1, 2, 2**32 - 1, 2**32, 2**63 - 2, 2**63 - 1,
                  2**63, 2**63 + 1, 2**64 - 2**32, 2**64 - 3, 2**64 - 2],
                 dtype=np.uint64)


def bucket_of_words(words, bits: int):
    """The bucket table row of each word (KmerIndex.bucket_table's CDF
    map)."""
    t = np.asarray(words, np.uint64) >> np.uint64(32)
    v = (t << np.uint64(1)) - ((t * t) >> np.uint64(32))
    return np.minimum(v >> np.uint64(32 - bits),
                      np.uint64((1 << bits) - 1)).astype(np.int64)


def bucket_index_words(rng, n_random: int = 5000, bits: int = 21):
    """Sorted index words whose bucket table (at `bits`, the smallest
    table KmerIndex.bucket_table makes) has rows of every count 0..8
    and rows that escape both ways: random words; for each k in 1..8 a
    bucket of k words whose t lie up to 3 apart (t-deltas 0..3); a run
    of 300 equal words (count > 8); a word 5000 below the edge words'
    t = 2^32 - 1 in the last bucket (a t-delta >= 2^12); the edge words;
    and every random word with its top bit set (across 2^63)."""
    rand = rng.integers(0, 2**63, n_random, dtype=np.uint64)
    groups = []
    for k in range(1, 9):
        while True:
            t = rng.integers(1 << 20, 1 << 31, dtype=np.uint64)
            ts = t + np.arange(k, dtype=np.uint64) // np.uint64(2)
            rows = bucket_of_words(ts << np.uint64(32), bits)
            if rows[0] == rows[-1]:
                break
        groups.append((ts << np.uint64(32)) |
                      rng.integers(0, 2**32, k, dtype=np.uint64))
    over = np.uint64((2**32 - 5000) << 32) | np.uint64(7)
    words = np.concatenate([rand, rand | np.uint64(2**63), *groups,
                            np.full(300, rand[100]), [over], EDGES])
    return np.sort(words)


def queries_for(words, rng, n: int = 400):
    """Query words against the sorted index `words`: every index word
    (hits), its neighbours -1 and +1, n random words, the edge words and
    the all-ones sentinel word."""
    return np.concatenate([
        words, words - np.uint64(1), words + np.uint64(1),
        rng.integers(0, 2**64 - 1, n, dtype=np.uint64), EDGES,
        [ALL_ONES]]).astype(np.uint64)


def prefix_index_words(rng, bits: int, window: int, m: int = 3000):
    """(sorted words, padded words, pstart) for the prefix window at
    (bits, window): m words whose top `bits` collide in runs, one run
    three windows long (uncovered); padded with >= 2 * window all-ones
    sentinels to a multiple of window, as db/kmer_index.join_columns
    pads; pstart int32 [2^bits + 1] the insertion point of each prefix."""
    km = (rng.integers(0, 1 << bits, m, dtype=np.uint64)
          << np.uint64(64 - bits)) | rng.integers(0, 4, m, dtype=np.uint64)
    km = np.sort(np.concatenate([km, np.full(3 * window, km[7])]))
    counts = np.bincount((km >> np.uint64(64 - bits)).astype(np.int64),
                         minlength=1 << bits)
    pstart = np.zeros((1 << bits) + 1, np.int32)
    np.cumsum(counts, out=pstart[1:])
    npad = 2 * window + (-(len(km) + 2 * window)) % window
    padded = np.concatenate([km, np.full(npad, ALL_ONES)])
    return km, padded, pstart
