"""The join's hand-written kernels (kslam_tpu_torch/csrc/join.cu) off
the card: a numpy model of each kernel's per-query steps, written to
mirror the CUDA source (bucket_join: the __umulhi CDF map, the row's
four 16 B lanes, the slot words and their compares; window_join: the
group's 16 B key pairs, each lane's packed counts, the shuffle
butterfly), held equal to the plain torch versions in ops/join.py on
the edge words, every bucket count 0..8, escaped buckets, sentinels and
uncovered window runs; the wrappers' operand checks and launch
configuration; and the CPU dispatch to the plain versions, which
launches nothing.  The kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 10).  No jax here."""

import os
import re

import numpy as np
import pytest
import torch

from kslam_tpu_torch.db.kmer_index import KmerIndex
from kslam_tpu_torch.eval import join_cases
from kslam_tpu_torch.ops import join, join_cuda, kmers

torch.set_num_threads(1)

U64, U32 = np.uint64, np.uint32
FLIP = U64(2**63)
ESCAPE = 1 << 30
SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "kslam_tpu_torch", "csrc", "join.cu")


def _umulhi(a, b):
    """__umulhi(a, b): the high 32 bits of the 64-bit product of two
    uint32."""
    return (a.astype(U64) * b.astype(U64)) >> U64(32)


def model_bucket_join(tbl, keys, bits: int):
    """bucket_join_kernel's steps for every query, in numpy."""
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
    return lo, hi, np.where(covered, 0, cnt).astype(np.int32), row, v


def model_window_join(keys_idx, pstart, keys, prefix_bits: int,
                      window: int):
    """window_join_kernel's steps for every query, in numpy: member m of
    the query's group of G lanes reads the key pair `pair` = pos0 / 2 +
    m + G k at steps k < w / G (none at or past the keys' end), packs
    lt | eq << 16, and the group sums the lanes' words with the xor
    butterfly; member 0 writes."""
    group, _, _ = join_cuda.launch_config(len(keys), window)
    steps = window // group
    n_keys = len(keys_idx)
    word = keys.view(U64) ^ FLIP
    p = (word >> U64(64 - prefix_bits)).astype(np.int64)
    start = pstart[p].astype(np.int64)
    end = pstart[p + 1].astype(np.int64)
    pos0 = start // window * window
    idx_words = keys_idx.view(U64) ^ FLIP
    member = np.arange(group)
    packed = np.zeros((len(keys), group), np.uint32)
    for k in range(steps):
        pair = pos0[:, None] // 2 + member[None, :] + group * k
        ok = 2 * pair < n_keys
        for half in (0, 1):
            x = idx_words[np.where(ok, 2 * pair + half, 0)]
            packed += (ok & (x < word[:, None])).astype(np.uint32) + \
                ((ok & (x == word[:, None])).astype(np.uint32) << 16)
    off = group >> 1
    while off:
        packed = packed + packed[:, member ^ off]
        off >>= 1
    assert (packed == packed[:, :1]).all()     # every lane holds the sum
    lt = (packed[:, 0] & 0xFFFF).astype(np.int64)
    eq = (packed[:, 0] >> 16).astype(np.int64)
    covered = end <= pos0 + 2 * window
    lo = np.where(covered, pos0 + lt, start)
    hi = np.where(covered, lo + eq, start)
    return lo, hi, np.where(covered, 0, end - start).astype(np.int32)


def _idx(words):
    z = np.zeros(len(words), np.int32)
    return KmerIndex(words, z, z, np.zeros(len(words), bool))


def _assert_equal(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


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


@pytest.mark.parametrize("bits,window", [(12, 4), (10, 8), (8, 16), (9, 32),
                                         (10, 64), (12, 128)])
def test_window_model_matches_plain(bits, window):
    rng = np.random.default_rng(37)
    km, padded, pstart = join_cases.prefix_index_words(rng, bits, window)
    q = join_cases.queries_for(km, rng)
    keys_idx = kmers.keys_from_words_np(padded)
    keys = kmers.keys_from_words_np(q)
    got = model_window_join(keys_idx, pstart, keys, bits, window)
    plain = join.lookup_prefix_window_plain(
        torch.as_tensor(keys_idx), torch.as_tensor(pstart),
        torch.as_tensor(keys), bits, window)
    _assert_equal(got, plain)
    lo, hi, unc = got
    covered = unc == 0
    assert covered.any() and not covered.all()      # an uncovered run
    np.testing.assert_array_equal(lo[covered],
                                  np.searchsorted(km, q[covered], "left"))
    # the all-ones query: the plain version counts the sentinels of the
    # two rows too (no canonical k-mer is all ones: it is the zero
    # k-mer's reverse complement)
    assert (q == join_cases.ALL_ONES).any()


def test_window_model_reads_nothing_past_the_keys():
    """A pstart that points at the last two rows: every pair read lies
    inside the keys, and a pstart past them (no valid input has one)
    counts nothing there."""
    rng = np.random.default_rng(41)
    km, padded, pstart = join_cases.prefix_index_words(rng, 8, 16)
    keys_idx = kmers.keys_from_words_np(padded)
    q = kmers.keys_from_words_np(km[-5:])
    short = keys_idx[:-16]                 # one sentinel row fewer
    lo, hi, unc = model_window_join(short, pstart, q, 8, 16)
    assert (hi <= len(short)).all()


@pytest.mark.parametrize("window", [0, 2, 8, 16, 32, 64, 128, 4096])
def test_launch_config(window):
    for n in (1, 255, 256, 257, 31_719_424):
        group, threads, blocks = join_cuda.launch_config(n, window)
        assert group == (min(window, 32) if window else 1)
        assert threads == join_cuda.THREADS and threads % 32 == 0
        assert 1 <= blocks <= join_cuda.MAX_BLOCKS
        per_block = threads // group
        # one query per thread (per group) unless the grid is capped
        assert blocks * per_block >= n or blocks == join_cuda.MAX_BLOCKS
        assert (blocks - 1) * per_block < n


def test_kernel_constants_match_the_source():
    """join.cu's constants are the wrapper's and the table's."""
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
    assert "% 16 != 0" in src and join_cuda.KEYS_ALIGN == 16


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
    """The kernels read 64 B table rows and 16 B key pairs: a view that
    starts off those boundaries is refused before a launch."""
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
    join_cuda.check_window(keys[start:start + 64], pstart, q, 4, 16,
                           aligned=True)
    with pytest.raises(ValueError, match="16 B aligned"):
        join_cuda.check_window(keys[start + 1:start + 65], pstart, q, 4, 16,
                               aligned=True)


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


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch functions themselves take CUDA tensors only."""
    tbl, q, bits = _bucket_operands()
    with pytest.raises(ValueError, match="no join kernel for device cpu"):
        join_cuda.bucket_join(tbl, q, bits)
    with pytest.raises(ValueError, match="no join kernel for device cpu"):
        join_cuda.window_join(*_window_operands())
