"""Direct-addressed joins of read k-mer keys against the sorted index.

Counterpart of kslam_tpu/ops/join.py, on tensors in the port's int64 key
encoding (ops/kmers.py: a key is the uint64 word with its top bit
flipped, so signed order of keys is unsigned order of words).  Each
lookup returns (lo, hi, uncovered): the left and right insertion points
of every query in the sorted index, and, where a table cannot answer a
query exactly (a bucket that escaped, a prefix run longer than the
window), lo == hi == the run's start and the run's length in
`uncovered`; ops/match.expand_seeds resolves those queries with the
exact search (tier 2).

  * lookup_sector: one 32 B row of the sector table per query
    (db/sector_table.py; the port's table, built on the keys' device:
    match.join_bounds' table on every single-device path),
  * lookup_bucket: one [Q, 16] int32 row of KmerIndex.bucket_table per
    query (the reference's table; no path joins with it),
  * lookup_prefix_window: two pstart entries and one [2 * window] row
    (two aligned rows) of the sentinel-padded index per query
    (KmerIndex.prefix_table),
  * build_prefix_rows / lookup_prefix_rows: the same join on a
    [M/w, 2w] overlapping-rows copy (no path uses this layout; the
    reference package keeps it too),
  * searchsorted_both: the exact join, torch.searchsorted on both sides.

searchsorted_both is the counterpart of searchsorted_blocked and
searchsorted_blocked_both.  Off a TPU those are jnp.searchsorted; their
dense bucket-and-refine form (force=True) exists only for the TPU's
vector unit, where a binary search's dependent scalar gathers are slow,
so it is not carried over.

The unsigned 64-bit arithmetic of the reference runs here on int64:
right shifts are masked (they are arithmetic on int64), u32 lanes of the
int32 table are read as `& 0xFFFFFFFF`, and the CDF map's t * t
(t < 2^32; sector_table.row_of, both tables' map) is split into 16-bit
halves so its floor is exact.

lookup_sector, lookup_bucket and lookup_prefix_window check their
operands (ops/join_cuda.py) and run a CPU tensor through their plain
versions, lookup_sector_plain, lookup_bucket_plain and
lookup_prefix_window_plain, and a CUDA tensor through the hand-written
kernels of csrc/join.cu (sector_join, bucket_join, window_join;
join_cuda.JOIN_LAUNCHES counts them); a CUDA tensor never falls back,
and any other device raises.  The plain versions run over
query slices, so the row gathers' temporaries stay bounded at any query
count (torch materialises what XLA fuses).
"""

from __future__ import annotations

import torch

from ..db import sector_table
from ..db.kmer_index import KmerIndex
from . import join_cuda
from .kmers import FLIP

ESCAPE = 1 << 30          # a bucket row's count flag: not answered here
U32 = 0xFFFFFFFF
# queries per slice: the bucket join's [slice, 16] int32 gather is
# 256 MiB at 2^22, and each [slice, 8] int64 slot temporary as much (the
# sector join's half of that)
SLICE_QUERIES = 1 << 22
# the window joins' [slice, 2w] int64 gather is capped at this many
# elements, 256 MiB
SLICE_ELEMS = 1 << 25


def _sliced(fn, queries, rows: int):
    """fn over `rows`-query slices of the flat queries, its (lo, hi,
    uncovered) concatenated and reshaped to the queries' shape."""
    q = queries.reshape(-1)
    if q.shape[0] <= rows:
        parts = [fn(q)]
    else:
        parts = [fn(q[i:i + rows]) for i in range(0, q.shape[0], rows)]
    return tuple(torch.cat(c).reshape(queries.shape) for c in zip(*parts))


def searchsorted_both(sorted_keys, queries):
    """(left, right) insertion points of `queries` in `sorted_keys`
    (int64), exact for runs of any length."""
    return (torch.searchsorted(sorted_keys, queries, right=False),
            torch.searchsorted(sorted_keys, queries, right=True))


def lookup_bucket(tbl, queries, bits: int):
    """(lo, hi, uncovered) via the bucket table (lookup_bucket_plain):
    the plain version for CPU tensors, the bucket_join kernel for CUDA
    ones."""
    if queries.device.type == "cpu":
        join_cuda.check_bucket(tbl, queries, bits)
        return lookup_bucket_plain(tbl, queries, bits)
    return join_cuda.bucket_join(tbl, queries, bits)


def lookup_bucket_plain(tbl, queries, bits: int):
    """(lo, hi, uncovered) via the one-gather bucket table
    (KmerIndex.bucket_table: int32 [2^bits, 16] rows of c0 start, c1
    count | ESCAPE, c2 t_base (u32), c3..c6 eight 12-bit t-deltas, two
    per word, c7..c14 eight low-32 words).  Queries of escaped buckets
    get lo == hi == start and the bucket's count in `uncovered`.
    lo and hi are int64, uncovered int32."""
    n_slots, delta_bits = KmerIndex.BUCKET_SLOTS, KmerIndex.BUCKET_DELTA_BITS
    slots = torch.arange(n_slots, device=queries.device)
    shifts = (slots % 2) * delta_bits

    def one(q):
        r = tbl[sector_table.row_of(q, bits)]    # [Q, 16] int32
        start = r[:, 0].to(torch.int64)
        cntf = r[:, 1]
        covered = cntf < ESCAPE
        cnt = cntf & (ESCAPE - 1)
        # each slot's word, (t_base + delta mod 2^32) << 32 | low32, as a
        # key: the reference's (t, low32) compare is the words' compare
        t = (r[:, 2:3].to(torch.int64) & U32) + \
            ((r[:, 3 + slots // 2].to(torch.int64) >> shifts)
             & ((1 << delta_bits) - 1))
        slot_keys = (((t & U32) << 32) |
                     (r[:, 7:7 + n_slots].to(torch.int64) & U32)) ^ FLIP
        in_run = slots[None, :] < cnt[:, None]
        qq = q[:, None]
        lo = start + torch.where(covered,
                                 ((slot_keys < qq) & in_run).sum(1), 0)
        hi = lo + torch.where(covered,
                              ((slot_keys == qq) & in_run).sum(1), 0)
        return lo, hi, torch.where(covered, 0, cnt)

    return _sliced(one, queries, SLICE_QUERIES)


def lookup_sector(tbl, queries, bits: int):
    """(lo, hi, uncovered) via the sector table (lookup_sector_plain):
    the plain version for CPU tensors, the sector_join kernel for CUDA
    ones."""
    if queries.device.type == "cpu":
        join_cuda.check_sector(tbl, queries, bits)
        return lookup_sector_plain(tbl, queries, bits)
    return join_cuda.sector_join(tbl, queries, bits)


def lookup_sector_plain(tbl, queries, bits: int):
    """(lo, hi, uncovered) via the sector table (db/sector_table.py:
    int32 [2^bits, 8] rows of w0 start, w1 t_base (u32), w2..w5 four
    low-32 words, w6..w7 four 12-bit t-deltas, the count and the escape
    bit).  Queries of escaped rows get lo == hi == start and the run's
    length (w2) in `uncovered`.  The sector_join kernel's arithmetic;
    lo and hi are int64, uncovered int32."""
    st = sector_table
    slots = torch.arange(st.SLOTS, device=queries.device)
    shifts = (slots % 2) * st.DELTA_BITS

    def one(q):
        r = tbl[st.row_of(q, bits)]              # [Q, 8] int32
        start = r[:, 0].to(torch.int64)
        info = r[:, 7]
        escaped = ((info >> st.ESCAPE_SHIFT) & 1) == 1
        cnt = (info >> st.COUNT_SHIFT) & 7
        t = (r[:, 1:2].to(torch.int64) & U32) + \
            ((r[:, 6 + slots // 2].to(torch.int64) >> shifts)
             & ((1 << st.DELTA_BITS) - 1))
        slot_keys = (((t & U32) << 32) |
                     (r[:, 2:2 + st.SLOTS].to(torch.int64) & U32)) ^ FLIP
        in_run = slots[None, :] < cnt[:, None]
        qq = q[:, None]
        lo = start + torch.where(escaped, 0,
                                 ((slot_keys < qq) & in_run).sum(1))
        hi = lo + torch.where(escaped, 0,
                              ((slot_keys == qq) & in_run).sum(1))
        return lo, hi, torch.where(escaped, r[:, 2], 0)

    return _sliced(one, queries, SLICE_QUERIES)


def _window_bounds(g, pos0, start, end, q, window: int):
    """(lo, hi, uncovered) from the gathered [Q, 2w] keys `g` of slots
    [pos0, pos0 + 2w): the slots before `start` hold smaller prefixes
    (keys < q) and those from `end` on larger ones or sentinels (keys >
    q), so counting every slot gives the reference's counts over the run
    [start, end) plus start - pos0.  Runs that end past the two rows are
    uncovered."""
    qq = q[:, None]
    lo = pos0 + (g < qq).sum(1)
    hi = lo + (g == qq).sum(1)
    covered = end <= pos0 + 2 * window
    lo = torch.where(covered, lo, start)
    hi = torch.where(covered, hi, start)
    return lo, hi, torch.where(covered, 0, end - start).to(torch.int32)


def _prefix(q, prefix_bits: int):
    """The top prefix_bits of each key's word."""
    return ((q ^ FLIP) >> (64 - prefix_bits)) & ((1 << prefix_bits) - 1)


def lookup_prefix_window(index_kmers, pstart, queries, prefix_bits: int,
                         window: int):
    """(lo, hi, uncovered) via prefix direct addressing
    (lookup_prefix_window_plain): the plain version for CPU tensors, the
    window_join kernel for CUDA ones."""
    if queries.device.type == "cpu":
        join_cuda.check_window(index_kmers, pstart, queries, prefix_bits,
                               window)
        return lookup_prefix_window_plain(index_kmers, pstart, queries,
                                          prefix_bits, window)
    return join_cuda.window_join(index_kmers, pstart, queries, prefix_bits,
                                 window)


def lookup_prefix_window_plain(index_kmers, pstart, queries,
                               prefix_bits: int, window: int):
    """(lo, hi, uncovered) via prefix direct addressing: the top
    prefix_bits of a query address pstart (int32 [2^bits + 1], the
    insertion point of each prefix), giving the slice [start, end)
    holding every key of that prefix, and the two aligned [window] rows
    r = start // window and r + 1 of the index cover any run of <=
    window keys that starts in row r.

    index_kmers: sorted int64 keys, padded to a multiple of window with
    >= 2 * window int64-max sentinels (db/kmer_index.join_columns)."""
    # row r of this overlapping view is slots [r*w, r*w + 2w): the two
    # aligned rows r and r + 1 in one gather, no copy of the index
    keys = index_kmers.contiguous()
    rows2w = keys.as_strided((keys.shape[0] // window - 1, 2 * window),
                             (window, 1))

    def one(q):
        p = _prefix(q, prefix_bits)
        start = pstart[p].to(torch.int64)
        end = pstart[p + 1].to(torch.int64)
        r = start // window
        return _window_bounds(rows2w[r], r * window, start, end, q,
                              window)

    return _sliced(one, queries, max(SLICE_ELEMS // (2 * window), 1))


def build_prefix_rows(index_kmers, pstart, window: int):
    """The overlapping-rows layout of lookup_prefix_rows: [M/w, 2w] key
    rows (row r covers slots [r*w, r*w + 2w), the last wrapping to the
    first) and the [2^bits, 2] (start, end) table."""
    rows = index_kmers.reshape(-1, window)
    rows2w = torch.cat([rows, torch.roll(rows, -1, dims=0)], dim=1)
    pstart2 = torch.stack([pstart[:-1], pstart[1:]], dim=1)
    return rows2w, pstart2


def lookup_prefix_rows(rows2w, pstart2, queries, prefix_bits: int,
                       window: int):
    """lookup_prefix_window on the build_prefix_rows layout: one [Q, 2]
    (start, end) gather and one [Q, 2w] row gather.  The wrapped last
    row is never read inside a run (the index carries >= 2w sentinels).
    """
    def one(q):
        se = pstart2[_prefix(q, prefix_bits)].to(torch.int64)
        start, end = se[:, 0], se[:, 1]
        r = start // window
        return _window_bounds(rows2w[r], r * window, start, end, q, window)

    return _sliced(one, queries, max(SLICE_ELEMS // (2 * window), 1))
