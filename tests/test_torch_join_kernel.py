"""The join's hand-written kernels (kslam_tpu_torch/csrc/join.cu) off
the card: a numpy model of each kernel's per-query steps, written to
mirror the CUDA source (bucket_join: the __umulhi CDF map, the row's
four 16 B lanes, the slot words and their compares; window_join: the
key, the two pstart entries, then only the run [start, end) of a
covered query, one slot of every run per step, and the all-ones edge;
both: tier 2's binary search of the escaped run), held equal to the
plain torch versions in ops/join.py and, with tier 2, to the CPU
match.join_bounds on the edge words, every bucket count 0..8, escaped
buckets, sentinels, long and uncovered prefix runs, the collapsed
prefixes of a mesh shard, windows 2 to 4096 and random q_ok masks; the
wrappers' operand checks and launch configuration; and the CPU
dispatch to the plain versions, which launches nothing.  The kernels
themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py phases 3 and 10).  No jax here."""

import os
import re

import numpy as np
import pytest
import torch

from kslam_tpu_torch.db.kmer_index import KmerIndex
from kslam_tpu_torch.eval import join_cases
from kslam_tpu_torch.ops import join, join_cuda, kmers, match

torch.set_num_threads(1)

U64, U32 = np.uint64, np.uint32
FLIP = U64(2**63)
ALL_ONES = join_cases.ALL_ONES
ESCAPE = 1 << 30
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kslam_tpu_torch", "csrc", "join.cu")


def _umulhi(a, b):
    """__umulhi(a, b): the high 32 bits of the 64-bit product of two
    uint32."""
    return (a.astype(U64) * b.astype(U64)) >> U64(32)


def _search(idx_words, a, b, word, upper: bool):
    """search<kUpper> for every query: the first position in [a, b)
    whose word is not below (upper: is above) the query's; the loop's
    midpoints as the kernel takes them."""
    a, b = a.copy(), b.copy()
    while True:
        live = a < b
        if not live.any():
            return a
        mid = a + ((b - a) >> 1)
        x = idx_words[np.where(live, mid, 0)]
        go = live & ((x <= word) if upper else (x < word))
        a = np.where(go, mid + 1, a)
        b = np.where(live & ~go, mid, b)


def _exact_bounds(idx_words, a, b, word):
    """exact_bounds: (lo, hi) of each query from its run [a, b); hi is
    the keys' length for the all-ones word."""
    n_keys = len(idx_words)
    b = np.minimum(b, n_keys)
    lo = _search(idx_words, a, b, word, False)
    hi = np.where(word == ALL_ONES, n_keys,
                  _search(idx_words, lo, b, word, True))
    return lo, hi


def model_bucket_join(tbl, keys, bits: int, keys_idx=None, q_ok=None):
    """bucket_join_kernel's steps for every query, in numpy; with q_ok
    (and the index keys) its tier 2 too, whose launch writes no
    uncovered (returned here all the same)."""
    word = keys.view(U64) ^ FLIP
    t = (word >> U64(32)).astype(U32)
    v = U64(2) * t.astype(U64) - _umulhi(t, t)
    row = np.minimum(v >> U64(32 - bits), U64((1 << bits) - 1))
    r = tbl[row.astype(np.int64)]
    a, b, c, d = r[:, 0:4], r[:, 4:8], r[:, 8:12], r[:, 12:16]
    deltas = [a[:, 3], b[:, 0], b[:, 1], b[:, 2]]
    lows = [b[:, 3], c[:, 0], c[:, 1], c[:, 2], c[:, 3], d[:, 0], d[:, 1],
            d[:, 2]]
    cnt = a[:, 1] & (ESCAPE - 1)
    t_base = a[:, 2].view(U32)
    lt = np.zeros(len(keys), np.int64)
    eq = np.zeros(len(keys), np.int64)
    for s in range(join_cuda.SLOTS):
        # int32 >> is arithmetic, then the 12-bit mask
        delta = ((deltas[s // 2] >> (join_cuda.DELTA_BITS * (s % 2)))
                 & ((1 << join_cuda.DELTA_BITS) - 1)).astype(U32)
        slot = ((t_base + delta).astype(U64) << U64(32)) | \
            lows[s].view(U32).astype(U64)
        in_run = s < cnt
        lt += in_run & (slot < word)
        eq += in_run & (slot == word)
    covered = a[:, 1] < ESCAPE
    lo = a[:, 0].astype(np.int64) + np.where(covered, lt, 0)
    hi = lo + np.where(covered, eq, 0)
    if q_ok is not None:
        sel = ~covered & (cnt > 0) & q_ok
        start = a[sel, 0].astype(np.int64)
        lo[sel], hi[sel] = _exact_bounds(keys_idx.view(U64) ^ FLIP, start,
                                         start + cnt[sel], word[sel])
    return lo, hi, np.where(covered, 0, cnt).astype(np.int32), row, v


def model_window_join(keys_idx, pstart, keys, prefix_bits: int,
                      window: int, q_ok=None):
    """window_join_kernel's steps for every query, in numpy: the key,
    pstart[p] and pstart[p + 1]; for a covered query the run's slots
    [start, min(end, n_keys)) one per step (every run of a thread's
    queries advances together), lo = start + lt, hi = lo + eq, or
    min(pos0 + 2w, n_keys) for the all-ones word; an uncovered query
    lo = hi = start, or with q_ok tier 2's search of [start, end)."""
    n_keys = len(keys_idx)
    word = keys.view(U64) ^ FLIP
    p = (word >> U64(64 - prefix_bits)).astype(np.int64)
    start = pstart[p].astype(np.int64)
    end = pstart[p + 1].astype(np.int64)
    pos0 = start // window * window
    covered = end <= pos0 + 2 * window
    stop = np.where(covered, np.minimum(end, n_keys), start)
    idx_words = keys_idx.view(U64) ^ FLIP
    lt = np.zeros(len(keys), np.int64)
    eq = np.zeros(len(keys), np.int64)
    live = np.flatnonzero(stop > start)
    k = 0
    while live.size:
        x = idx_words[start[live] + k]
        lt[live] += x < word[live]
        eq[live] += x == word[live]
        k += 1
        live = live[start[live] + k < stop[live]]
    assert k <= 2 * window           # a covered run is <= 2w slots
    lo = np.where(covered, start + lt, start)
    hi = np.where(covered,
                  np.where(word == ALL_ONES,
                           np.minimum(pos0 + 2 * window, n_keys), lo + eq),
                  start)
    if q_ok is not None:
        sel = ~covered & q_ok
        lo[sel], hi[sel] = _exact_bounds(idx_words, start[sel], end[sel],
                                         word[sel])
    return lo, hi, np.where(covered, 0, end - start).astype(np.int32)


def _idx(words):
    z = np.zeros(len(words), np.int32)
    return KmerIndex(words, z, z, np.zeros(len(words), bool))


def _assert_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _queries(words, rng, limit: int = 0):
    """join_cases.queries_for, cut to `limit` queries (the edge words and
    the all-ones word kept) where the plain window's [Q, 2w] gather
    would be large."""
    q = join_cases.queries_for(words, rng)
    tail = len(join_cases.EDGES) + 1
    if limit and len(q) > limit:
        pick = np.sort(rng.choice(len(q) - tail, limit - tail,
                                  replace=False))
        q = np.concatenate([q[pick], q[-tail:]])
    return q


def _masks(rng, n: int):
    """q_ok patterns: all kept, none kept, a random half."""
    return {"all": np.ones(n, bool), "none": np.zeros(n, bool),
            "random": rng.random(n) < 0.5}


def _cpu_join_bounds(q_ok, keys, **tables):
    """match.join_bounds on CPU tensors (the plain lookup and tier 2)."""
    return match.join_bounds(torch.as_tensor(keys), torch.as_tensor(q_ok),
                             **tables)


def _window_vs_plain_and_join_bounds(keys_idx, pstart, keys, bits, window,
                                     rng):
    """The window model equals lookup_prefix_window_plain and, with tier
    2 for each q_ok pattern, the CPU match.join_bounds; returns the
    lookup model's (lo, hi, uncovered)."""
    got = model_window_join(keys_idx, pstart, keys, bits, window)
    k_t, p_t = torch.as_tensor(keys_idx), torch.as_tensor(pstart)
    _assert_equal(got, join.lookup_prefix_window_plain(
        k_t, p_t, torch.as_tensor(keys), bits, window))
    for name, q_ok in _masks(rng, len(keys)).items():
        fused = model_window_join(keys_idx, pstart, keys, bits, window,
                                  q_ok=q_ok)
        want = _cpu_join_bounds(q_ok, keys, index_kmers=k_t, idx_pstart=p_t,
                                prefix_bits=bits, window=window)
        _assert_equal(fused[:2], want)
    return got


@pytest.mark.parametrize("bits", [16, 21])
def test_bucket_model_matches_plain(bits):
    rng = np.random.default_rng(31)
    words = join_cases.bucket_index_words(rng, bits=bits)
    tbl, got_bits = _idx(words).bucket_table(bits=bits)
    assert got_bits == bits
    q = join_cases.queries_for(words, rng)
    keys = kmers.keys_from_words_np(q)
    lo, hi, unc, row, v = model_bucket_join(tbl, keys, bits)
    plain = join.lookup_bucket_plain(torch.from_numpy(tbl),
                                     torch.as_tensor(keys), bits)
    _assert_equal((lo, hi, unc), plain)
    # what the queries reached: every count 0..8 of a covered row, rows
    # escaped by count and by a t-delta overflow, the clamped CDF edge,
    # keys on both sides of 2^63, the sentinel word
    cntf = tbl[row.astype(np.int64), 1]
    covered = cntf < ESCAPE
    if bits == 21:
        assert set(range(9)) <= set(cntf[covered].tolist())
        assert ((~covered) & ((cntf & (ESCAPE - 1)) > 8)).any()
        assert ((~covered) & ((cntf & (ESCAPE - 1)) <= 8)).any()
    else:
        assert not covered.all() and covered.any()
    assert (v == 2**32).any() and (row == (1 << bits) - 1).any()
    assert (q < FLIP).any() and (q >= FLIP).any()
    assert (q == join_cases.ALL_ONES).any()
    np.testing.assert_array_equal(lo[covered],
                                  np.searchsorted(words, q[covered], "left"))
    np.testing.assert_array_equal(hi[covered],
                                  np.searchsorted(words, q[covered],
                                                  "right"))
    np.testing.assert_array_equal(unc[~covered],
                                  cntf[~covered] & (ESCAPE - 1))


@pytest.mark.parametrize("mask", ["all", "none", "random"])
@pytest.mark.parametrize("bits", [16, 21])
def test_bucket_tier2_model_matches_join_bounds(bits, mask):
    """bucket_join with tier 2 (one launch of match.join_bounds on the
    card) equals the CPU join_bounds on every query, for every q_ok
    pattern: escaped rows of every kind searched in their run, the
    all-ones word's upper bound at the padded keys' end."""
    rng = np.random.default_rng(71)
    words = join_cases.bucket_index_words(rng, bits=bits)
    tbl, _ = _idx(words).bucket_table(bits=bits)
    padded = join_cases.sentinel_padded(words, 16)
    keys_idx = kmers.keys_from_words_np(padded)
    q = join_cases.queries_for(words, rng)
    keys = kmers.keys_from_words_np(q)
    q_ok = _masks(rng, len(q))[mask]
    lo, hi, unc, _, _ = model_bucket_join(tbl, keys, bits, keys_idx, q_ok)
    want = _cpu_join_bounds(q_ok, keys, index_kmers=torch.as_tensor(keys_idx),
                            idx_bucket=torch.from_numpy(tbl),
                            bucket_bits=bits)
    _assert_equal((lo, hi), want)
    tier2 = q_ok & (unc > 0)
    if mask != "none":
        assert tier2.any()
        np.testing.assert_array_equal(
            lo[tier2], np.searchsorted(padded, q[tier2], "left"))
        np.testing.assert_array_equal(
            hi[tier2], np.searchsorted(padded, q[tier2], "right"))


@pytest.mark.parametrize("bits,window", [(12, 4), (10, 8), (8, 16), (9, 32),
                                         (10, 64), (12, 128), (8, 2),
                                         (9, 256), (8, 4096)])
def test_window_model_matches_plain(bits, window):
    rng = np.random.default_rng(37)
    km, padded, pstart = join_cases.prefix_index_words(rng, bits, window)
    q = _queries(km, rng, limit=4000 if window > 256 else 0)
    keys_idx = kmers.keys_from_words_np(padded)
    keys = kmers.keys_from_words_np(q)
    lo, hi, unc = _window_vs_plain_and_join_bounds(keys_idx, pstart, keys,
                                                   bits, window, rng)
    covered = unc == 0
    assert covered.any() and not covered.all()      # an uncovered run
    np.testing.assert_array_equal(lo[covered],
                                  np.searchsorted(km, q[covered], "left"))
    # the all-ones query: the plain version counts the sentinels of the
    # two rows too (no canonical k-mer is all ones: it is the zero
    # k-mer's reverse complement)
    assert (q == join_cases.ALL_ONES).any()


@pytest.mark.parametrize("bits,window", [(8, 2), (9, 4), (8, 16), (10, 128),
                                         (6, 1024), (6, 4096)])
def test_window_model_on_edge_runs(bits, window):
    """Runs the run-only read treats apart: a long prefix run of 3w + 1
    words (uncovered; tier 2 searches it), the last prefix holding real
    all-ones words before the sentinels, the zero word; equal to the
    plain version and to the CPU join_bounds for every q_ok pattern."""
    rng = np.random.default_rng(73)
    km, padded, pstart = join_cases.run_edge_words(rng, bits, window)
    q = _queries(km, rng, limit=3000 if window > 256 else 0)
    lo, hi, unc = _window_vs_plain_and_join_bounds(
        kmers.keys_from_words_np(padded), pstart,
        kmers.keys_from_words_np(q), bits, window, rng)
    assert (unc > 3 * window).any()                  # the long run
    # the all-ones query, covered: the run's two all-ones keys and the
    # sentinels up to the two rows' end
    ones = (q == ALL_ONES) & (unc == 0)
    if window >= 8:
        assert ones.any()
    assert (hi[ones] - lo[ones] >= 2).all()


@pytest.mark.parametrize("lo_frac,hi_frac", [(0.0, 0.4), (0.3, 0.7),
                                             (0.6, 1.0)])
def test_window_model_on_collapsed_shard(lo_frac, hi_frac):
    """A mesh shard's clipped pstart (parallel/dist.shard_database):
    every prefix outside the shard's slice is an empty run at one of its
    ends; the model equals the plain version and the CPU join_bounds on
    the shard for every q_ok pattern, and the queries of prefixes before
    or past the slice land on its start or its end."""
    rng = np.random.default_rng(79)
    bits, window = 8, 16
    km, _, pstart = join_cases.run_edge_words(rng, bits, window)
    lo_i, hi_i = int(lo_frac * len(km)), int(hi_frac * len(km))
    padded, clipped = join_cases.prefix_shard(km, pstart, lo_i, hi_i, window)
    q = join_cases.queries_for(km, rng)
    keys = kmers.keys_from_words_np(q)
    lo, hi, unc = _window_vs_plain_and_join_bounds(
        kmers.keys_from_words_np(padded), clipped, keys, bits, window, rng)
    p = (q >> U64(64 - bits)).astype(np.int64)
    empty = (clipped[p] == clipped[p + 1]) & (q != ALL_ONES)
    assert empty.any() and (unc[empty] == 0).all()
    at_start = empty & (clipped[p] == 0)
    at_end = empty & (clipped[p] == hi_i - lo_i)
    assert at_start.any() or lo_i == 0
    assert at_end.any() or hi_i == len(km)
    assert (lo[at_start] == 0).all() and (hi[at_start] == 0).all()
    assert (lo[at_end] == hi_i - lo_i).all()
    assert (hi[at_end] == hi_i - lo_i).all()


def test_window_model_reads_nothing_past_the_keys():
    """A pstart that points at the last two rows: every run read lies
    inside the keys, and the all-ones query's upper bound stops at
    their end (no valid input has a shorter padding)."""
    rng = np.random.default_rng(41)
    km, padded, pstart = join_cases.prefix_index_words(rng, 8, 16)
    keys_idx = kmers.keys_from_words_np(padded)
    q = kmers.keys_from_words_np(np.concatenate([km[-5:], [ALL_ONES]]))
    short = keys_idx[:len(km) + 4]         # four sentinels, not 2w
    lo, hi, unc = model_window_join(short, pstart, q, 8, 16)
    assert (hi <= len(short)).all()
    # the all-ones word's run is covered and its two rows pass the end
    assert unc[-1] == 0 and pstart[-2] // 16 * 16 + 32 > len(short)
    assert hi[-1] == len(short)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000, 31_719_424,
                               join_cuda.THREADS * join_cuda.MAX_BLOCKS,
                               join_cuda.THREADS * join_cuda.MAX_BLOCKS + 1])
def test_launch_config(n):
    """One thread per query for both kernels; the grid-stride loop
    (query i = thread + g * grid) covers every query exactly once, and
    the grid is capped at MAX_BLOCKS."""
    threads, blocks = join_cuda.launch_config(n)
    assert threads == join_cuda.THREADS and threads % 32 == 0
    assert 1 <= blocks <= join_cuda.MAX_BLOCKS
    # one thread per query unless the grid is capped
    assert blocks * threads >= n or blocks == join_cuda.MAX_BLOCKS
    assert (blocks - 1) * threads < n
    if n <= 1000:
        grid = blocks * threads
        seen = np.zeros(n, np.int64)
        for g in range(-(-n // grid)):
            i = np.arange(grid) + g * grid
            np.add.at(seen, i[i < n], 1)
        assert (seen == 1).all()


def test_kernel_constants_match_the_source():
    """join.cu's constants are the wrapper's and the table's, and each
    kernel is built in both modes (lookup, tier 2)."""
    src = open(SOURCE).read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert const("kSlots") == join_cuda.SLOTS == KmerIndex.BUCKET_SLOTS
    assert const("kDeltaBits") == join_cuda.DELTA_BITS == \
        KmerIndex.BUCKET_DELTA_BITS
    assert const("kMaxThreads") == join_cuda.THREADS
    assert const("kMaxWindow") == join_cuda.MAX_WINDOW
    assert "% 64 != 0" in src and join_cuda.TABLE_ALIGN == 64
    for kernel in ("bucket_join_kernel", "window_join_kernel"):
        assert f"&{kernel}<true>" in src and f"&{kernel}<false>" in src
    assert "kAllOnes = ~0ull" in src and ALL_ONES == U64(2**64 - 1)


def _bucket_operands():
    tbl = torch.zeros((1 << 4, 16), dtype=torch.int32)
    return tbl, torch.zeros(10, dtype=torch.int64), 4


def _window_operands():
    return (torch.zeros(64, dtype=torch.int64),
            torch.zeros(17, dtype=torch.int32),
            torch.zeros(10, dtype=torch.int64), 4, 16)


BAD_BUCKET = {
    "tbl_dtype": lambda t, q, b: (t.to(torch.int64), q, b),
    "tbl_rows": lambda t, q, b: (t[1:], q, b),
    "tbl_width": lambda t, q, b: (t[:, :8].contiguous(), q, b),
    "tbl_non_contiguous": lambda t, q, b: (
        torch.zeros((16, 32), dtype=torch.int32)[:, ::2], q, b),
    "query_dtype": lambda t, q, b: (t, q.to(torch.int32), b),
    "query_non_contiguous": lambda t, q, b: (
        t, torch.zeros(20, dtype=torch.int64)[::2], b),
    "bits_zero": lambda t, q, b: (t, q, 0),
    "bits_33": lambda t, q, b: (t, q, 33),
    "devices_differ": lambda t, q, b: (t, q.to("meta"), b),
}


@pytest.mark.parametrize("case", sorted(BAD_BUCKET))
def test_bucket_operand_checks(case):
    args = BAD_BUCKET[case](*_bucket_operands())
    with pytest.raises(ValueError):
        join.lookup_bucket(*args)
    with pytest.raises(ValueError):
        join_cuda.check_bucket(*args)


BAD_WINDOW = {
    "keys_dtype": lambda k, p, q, b, w: (k.to(torch.int32), p, q, b, w),
    "keys_2d": lambda k, p, q, b, w: (k.reshape(4, 16), p, q, b, w),
    "keys_non_contiguous": lambda k, p, q, b, w: (
        torch.zeros(128, dtype=torch.int64)[::2], p, q, b, w),
    "keys_not_rows": lambda k, p, q, b, w: (k[:56], p, q, b, w),
    "keys_one_row": lambda k, p, q, b, w: (k[:16], p, q, b, w),
    "pstart_dtype": lambda k, p, q, b, w: (k, p.to(torch.int64), q, b, w),
    "pstart_length": lambda k, p, q, b, w: (k, p[:16], q, b, w),
    "query_dtype": lambda k, p, q, b, w: (k, p, q.to(torch.int32), b, w),
    "window_24": lambda k, p, q, b, w: (k, p, q, b, 24),
    "window_1": lambda k, p, q, b, w: (k, p, q, b, 1),
    "window_8192": lambda k, p, q, b, w: (k, p, q, b, 8192),
    "prefix_bits_zero": lambda k, p, q, b, w: (k, p, q, 0, w),
    "devices_differ": lambda k, p, q, b, w: (k.to("meta"), p, q, b, w),
}


@pytest.mark.parametrize("case", sorted(BAD_WINDOW))
def test_window_operand_checks(case):
    args = BAD_WINDOW[case](*_window_operands())
    with pytest.raises(ValueError):
        join.lookup_prefix_window(*args)
    with pytest.raises(ValueError):
        join_cuda.check_window(*args)


def test_alignment_checks():
    """bucket_join reads 64 B table rows: a view that starts off that
    boundary is refused before a launch.  window_join reads 8 B keys, so
    any int64 view of them is taken."""
    flat = torch.zeros(17 * 16 + 16, dtype=torch.int32)
    base = (-flat.data_ptr() % 64) // 4
    tbl = flat[base:base + 16 * 16].view(16, 16)
    join_cuda.check_bucket(tbl, torch.zeros(3, dtype=torch.int64), 4,
                           aligned=True)
    off = flat[base + 4:base + 4 + 16 * 16].view(16, 16)
    with pytest.raises(ValueError, match="64 B aligned"):
        join_cuda.check_bucket(off, torch.zeros(3, dtype=torch.int64), 4,
                               aligned=True)
    keys = torch.zeros(80, dtype=torch.int64)
    start = (-keys.data_ptr() % 16) // 8
    pstart = torch.zeros(17, dtype=torch.int32)
    q = torch.zeros(3, dtype=torch.int64)
    join_cuda.check_window(keys[start:start + 64], pstart, q, 4, 16)
    join_cuda.check_window(keys[start + 1:start + 65], pstart, q, 4, 16)


BAD_TIER2 = {
    "keys_dtype": lambda k, m, q: (k.to(torch.int32), m, q),
    "keys_2d": lambda k, m, q: (k.reshape(4, 16), m, q),
    "keys_empty": lambda k, m, q: (k[:0], m, q),
    "keys_non_contiguous": lambda k, m, q: (
        torch.zeros(128, dtype=torch.int64)[::2], m, q),
    "mask_dtype": lambda k, m, q: (k, m.to(torch.uint8), q),
    "mask_shape": lambda k, m, q: (k, m[:5], q),
    "mask_non_contiguous": lambda k, m, q: (
        k, torch.ones(20, dtype=torch.bool)[::2], q),
    "devices_differ": lambda k, m, q: (k, m.to("meta"), q),
}


@pytest.mark.parametrize("case", sorted(BAD_TIER2))
def test_tier2_operand_checks(case):
    """The fused launches' extra operands: the index keys and q_ok."""
    keys, mask, q = BAD_TIER2[case](torch.zeros(64, dtype=torch.int64),
                                    torch.ones(10, dtype=torch.bool),
                                    torch.zeros(10, dtype=torch.int64))
    with pytest.raises(ValueError):
        join_cuda.check_tier2(keys, mask, q)


def test_cpu_dispatch_runs_the_plain_versions():
    """On CPU tensors the public lookups equal their plain versions,
    keep the queries' shape, and launch no kernel; zero queries give
    empty outputs."""
    rng = np.random.default_rng(43)
    words = join_cases.bucket_index_words(rng, n_random=500, bits=16)
    tbl, bits = _idx(words).bucket_table(bits=16)
    tbl = torch.from_numpy(tbl)
    km, padded, pstart = join_cases.prefix_index_words(rng, 8, 16)
    keys_idx = torch.as_tensor(kmers.keys_from_words_np(padded))
    pstart = torch.as_tensor(pstart)
    before = dict(join_cuda.JOIN_LAUNCHES)
    for n in (0, 1, 257):
        q = torch.as_tensor(kmers.keys_from_words_np(
            join_cases.queries_for(words, rng)[:n]))
        for got, want in (
                (join.lookup_bucket(tbl, q, bits),
                 join.lookup_bucket_plain(tbl, q, bits)),
                (join.lookup_prefix_window(keys_idx, pstart, q, 8, 16),
                 join.lookup_prefix_window_plain(keys_idx, pstart, q, 8,
                                                 16))):
            for a, b, dt in zip(got, want, (torch.int64, torch.int64,
                                            torch.int32)):
                assert a.dtype == dt and a.shape == q.shape
                assert torch.equal(a, b)
        q2 = q.reshape(1, -1)
        assert join.lookup_bucket(tbl, q2, bits)[0].shape == q2.shape
    assert join_cuda.JOIN_LAUNCHES == before


def test_cpu_join_bounds_launches_nothing():
    """match.join_bounds on CPU tensors is the plain lookup and tier 2
    (equal to the exact search on kept queries) and launches nothing."""
    rng = np.random.default_rng(83)
    words = join_cases.bucket_index_words(rng, n_random=500, bits=16)
    tbl, bits = _idx(words).bucket_table(bits=16)
    keys_idx = torch.as_tensor(kmers.keys_from_words_np(
        join_cases.sentinel_padded(words, 16)))
    q_np = join_cases.queries_for(words, rng)
    q = torch.as_tensor(kmers.keys_from_words_np(q_np))
    q_ok = torch.as_tensor(q_np != ALL_ONES)
    before = dict(join_cuda.JOIN_LAUNCHES)
    lo, hi = match.join_bounds(q, q_ok, keys_idx,
                               idx_bucket=torch.from_numpy(tbl),
                               bucket_bits=bits)
    exact = join.searchsorted_both(keys_idx, q)
    assert torch.equal(lo[q_ok], exact[0][q_ok])
    assert torch.equal(hi[q_ok], exact[1][q_ok])
    assert join_cuda.JOIN_LAUNCHES == before


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch functions themselves take CUDA tensors only, in either
    mode."""
    tbl, q, bits = _bucket_operands()
    keys, pstart, q, pbits, window = _window_operands()
    q_ok = torch.ones(q.shape, dtype=torch.bool)
    with pytest.raises(ValueError, match="no join kernel for device cpu"):
        join_cuda.bucket_join(tbl, q, bits)
    with pytest.raises(ValueError, match="no join kernel for device cpu"):
        join_cuda.bucket_join_bounds(tbl, q, bits, keys, q_ok)
    with pytest.raises(ValueError, match="no join kernel for device cpu"):
        join_cuda.window_join(keys, pstart, q, pbits, window)
    with pytest.raises(ValueError, match="no join kernel for device cpu"):
        join_cuda.window_join_bounds(keys, pstart, q, pbits, window, q_ok)
