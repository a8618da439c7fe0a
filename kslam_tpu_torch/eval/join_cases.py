"""Index and query words that reach every branch of the join's lookups
(ops/join.py: the sector table, the bucket table and the prefix
window), for the tests of
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


def sector_index_words(rng, n_random: int = 5000, bits: int = 21):
    """Sorted index words whose sector table (db/sector_table.py) at
    `bits` has rows of every count 0..6 and rows that escape both ways:
    random words (both halves of the word space); for each k in 1..6 a
    row of k words whose t lie up to 2 apart (5 and 6 escape by count);
    a row of four words whose last t-delta is 2^12 - 1 (covered) and one
    of two words 2^12 apart (escapes by delta); a run of 300 equal words;
    and the edge words (t = 2^32 - 1: the CDF map's clamp into the last
    row).  The planted rows hold no random word."""
    rand = rng.integers(0, 2**63, n_random, dtype=np.uint64)
    rand = np.concatenate([rand, rand | np.uint64(2**63)])
    taken = set(bucket_of_words(np.concatenate([rand, EDGES]),
                                bits).tolist())

    def planted(ts):
        """The words of t values ts in one free row (a fresh base t per
        try)."""
        for _ in range(10000):
            base = rng.integers(3 << 30, (1 << 32) - (1 << 24),
                                dtype=np.uint64)
            t = base + ts.astype(np.uint64)
            rows = bucket_of_words(t << np.uint64(32), bits)
            if rows[0] == rows[-1] and int(rows[0]) not in taken:
                taken.add(int(rows[0]))
                return (t << np.uint64(32)) | \
                    rng.integers(0, 2**32, len(t), dtype=np.uint64)
        raise ValueError(f"no free row at {bits} bits")

    groups = [planted(np.arange(k) // 2) for k in range(1, 7)]
    groups.append(planted(np.array([0, 1, 7, (1 << 12) - 1])))
    groups.append(planted(np.array([0, 1 << 12])))
    words = np.concatenate([rand, *groups, np.full(300, rand[100]), EDGES])
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
    return (km, *_prefix_addressed(km, bits, window))


def sentinel_padded(km, window: int):
    """km padded with >= 2 * window all-ones sentinels to a multiple of
    window, as db/kmer_index.join_columns pads."""
    npad = 2 * window + (-(len(km) + 2 * window)) % window
    return np.concatenate([km, np.full(npad, ALL_ONES)])


def _prefix_addressed(km, bits: int, window: int):
    """(padded words, pstart int32 [2^bits + 1]: the insertion point of
    each prefix) of the sorted words km."""
    counts = np.bincount((km >> np.uint64(64 - bits)).astype(np.int64),
                         minlength=1 << bits)
    pstart = np.zeros((1 << bits) + 1, np.int32)
    np.cumsum(counts, out=pstart[1:])
    return sentinel_padded(km, window), pstart


def run_edge_words(rng, bits: int, window: int, m: int = 2000):
    """(sorted words, padded words, pstart) at (bits, window) with the
    runs a run-reading join treats apart: m words over m / 4 prefixes
    (runs of a few keys); one prefix holding a run of 3 * window + 1
    words, some repeated (uncovered: tier 2 searches it); the last
    prefix, the all-ones word's, holding five words and two real
    all-ones words before the sentinels; and the zero word.  Padded and
    addressed as prefix_index_words."""
    shift = np.uint64(64 - bits)
    tops = rng.integers(0, 1 << bits, max(m // 4, 1), dtype=np.uint64)
    km = (rng.choice(tops, m) << shift) | \
        rng.integers(0, 1 << 20, m, dtype=np.uint64)
    long_run = (tops[0] << shift) | \
        rng.integers(0, 2 * window, 3 * window + 1, dtype=np.uint64)
    last = np.uint64((1 << bits) - 1) << shift
    tail = np.concatenate([last | rng.integers(0, 8, 5, dtype=np.uint64),
                           [ALL_ONES, ALL_ONES]])
    km = np.sort(np.concatenate([km, long_run, tail,
                                 np.zeros(1, np.uint64)]))
    return (km, *_prefix_addressed(km, bits, window))


def prefix_shard(km, pstart, lo: int, hi: int, window: int):
    """(padded shard words, shard pstart) of the sorted words' slice
    [lo, hi) as parallel/dist.shard_database lays out a mesh shard: the
    slice padded with sentinels, and pstart clipped to it, so every
    prefix outside the slice collapses to an empty run at one of its
    ends."""
    clipped = np.clip(pstart.astype(np.int64) - lo, 0, hi - lo)
    return sentinel_padded(km[lo:hi], window), clipped.astype(np.int32)
