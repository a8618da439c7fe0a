"""Device match engine: read k-mers vs presorted index, no runtime mega-sort.

Replaces the reference's union-sort + pileup scan (SLAM.h:63-66,
Overlap.h:153-295) with:

  1. a join of every read k-mer key against the sorted index keys
     (ops/join.py: the port's sector table, then the bucket table, the
     prefix window or the exact search, in the reference package's
     order), whose escaped queries an exact tier 2 resolves, so the
     bounds are exact for any pileup,
  2. pair expansion (read k-mer x index slot), sized exactly by default:
     torch shapes are dynamic, so the pair count is read once and nothing
     is ever dropped to a static capacity,
  3. a lexicographic device sort by (read, entry, relPos, rc),
  4. exact chained dedup of |delta relPos| < 3 (Overlap.h:79-85).

Counterpart of kslam_tpu/ops/match.py.  Invalid rows are parked at
int32 max so they sort to the tail, as in the reference package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import K
from ..utils import metrics
from . import join, join_cuda
from .kmers import FLIP
from .rows import lex_perm, shift1

INT32_MAX = 2**31 - 1
INT64_MAX = 2**63 - 1


class Overlaps(NamedTuple):
    """Columnar overlap set; rows beyond `count` are padding."""
    read_id: torch.Tensor   # int32 [P]
    entry_id: torch.Tensor  # int32 [P]
    rel_pos: torch.Tensor   # int32 [P]
    rc: torch.Tensor        # bool  [P]
    valid: torch.Tensor     # bool  [P]
    count: torch.Tensor     # int32 [] number of valid rows
    overflow: torch.Tensor  # int64 [] pairs dropped by fanout/capacity caps
    needed_capacity: torch.Tensor = None  # int64 [] total unclipped pairs
    max_fanout: torch.Tensor = None       # int32 [] max per-k-mer matches


def _emit_pairs(lo, clipped, q_pack, idx_pack, n_index: int,
                capacity: int):
    """Pair expansion: query q emits `clipped[q]` pairs against index
    slots [lo[q], lo[q]+clipped[q]), cut to `capacity` rows, packed into
    the (key1, key2) sort words.  Returns (key1, key2, cap_overflow,
    total64)."""
    dev = lo.device
    starts64 = torch.cumsum(clipped.to(torch.int64), 0) - clipped
    total64 = starts64[-1] + clipped[-1]
    cap_overflow = torch.clamp(total64 - capacity, min=0)
    total = torch.clamp(total64, max=capacity)

    # pair p belongs to query q = last q with starts[q] <= p
    p = torch.arange(capacity, dtype=torch.int64, device=dev)
    q_idx = torch.searchsorted(starts64, p, right=True) - 1
    q_idx = torch.clamp(q_idx, 0, len(q_pack) - 1)
    in_range = p < total
    qp = q_pack[q_idx]
    slot = lo[q_idx] + (p - starts64[q_idx])
    slot = torch.clamp(slot, 0, n_index - 1)
    ip = idx_pack[slot]

    # idx_pack = entry<<33 | offset<<1 | rc as 64-bit words: the right
    # shifts below are arithmetic on int64, so every field is masked
    e_id = ((ip >> 33) & 0x7FFFFFFF).to(torch.int32)
    gb_off = ((ip >> 1) & 0xFFFFFFFF).to(torch.int32)
    gb_rc = (ip & 1).to(torch.bool)
    r_id = (qp >> 21).to(torch.int32)
    r_off = ((qp >> 11) & 0x3FF).to(torch.int32)
    r_off_rcspace = ((qp >> 1) & 0x3FF).to(torch.int32)
    r_rc = (qp & 1).to(torch.bool)

    # relativePosition and rc flags (Overlap.h:182-192)
    offset = torch.where(gb_rc, r_off_rcspace, r_off)
    rel = (gb_off - offset).to(torch.int32)
    rc = gb_rc != r_rc

    # overlapSort (Overlap.h:87-98) + rc as a determinism-only last key;
    # read and entry ids are < 2^31, so key1 < int64 max (the sentinel)
    key1 = (r_id.to(torch.int64) << 32) | e_id.to(torch.int64)
    key1 = torch.where(in_range, key1, INT64_MAX)
    key2 = ((rel.to(torch.int64) + 2**31) << 1) | rc.to(torch.int64)
    return key1, key2, cap_overflow, total64


def join_bounds(q_kmer, q_ok, index_kmers, idx_pstart=None,
                prefix_bits: int = 0, window: int = 0, idx_rows=None,
                idx_pstart2=None, idx_bucket=None, bucket_bits: int = 0,
                idx_sector=None, sector_bits: int = 0):
    """(lo, hi) int64 insertion bounds of the keys q_kmer [Q] in the
    sorted index keys, exact wherever q_ok.  Backends: the port's
    sector table, then the reference package's order
    (kslam_tpu/ops/match.py expand_seeds):
      * idx_sector/sector_bits: the one-sector table
        (db/sector_table.py, align.DeviceDB's),
      * idx_bucket/bucket_bits: the one-gather bucket table,
      * idx_rows/idx_pstart2: the overlapping-rows prefix layout,
      * idx_pstart/prefix_bits/window: the prefix window,
      * none: the exact search.
    Tier 2: the q_ok queries a table leaves uncovered are compacted,
    searched exactly in index_kmers, and their bounds put back in place,
    so their pairs expand with all others (the reference appends them as
    a block; finish_overlaps' sort makes the order moot).

    Off the CPU each table is one launch of its kernel with tier 2
    inside it (join_cuda.sector_join_bounds, bucket_join_bounds,
    window_join_bounds): the same (lo, hi) on every query, with no
    compaction and no host synchronisation."""
    on_card = q_kmer.device.type != "cpu"
    if idx_sector is not None and sector_bits:
        if on_card:
            return join_cuda.sector_join_bounds(idx_sector, q_kmer,
                                                sector_bits, index_kmers,
                                                q_ok)
        lo, hi, uncovered = join.lookup_sector(idx_sector, q_kmer,
                                               sector_bits)
    elif idx_bucket is not None and bucket_bits:
        if on_card:
            return join_cuda.bucket_join_bounds(idx_bucket, q_kmer,
                                                bucket_bits, index_kmers,
                                                q_ok)
        lo, hi, uncovered = join.lookup_bucket(idx_bucket, q_kmer,
                                               bucket_bits)
    elif idx_rows is not None and prefix_bits:
        lo, hi, uncovered = join.lookup_prefix_rows(
            idx_rows, idx_pstart2, q_kmer, prefix_bits, window)
    elif idx_pstart is not None and prefix_bits:
        if on_card:
            return join_cuda.window_join_bounds(index_kmers, idx_pstart,
                                                q_kmer, prefix_bits, window,
                                                q_ok)
        lo, hi, uncovered = join.lookup_prefix_window(
            index_kmers, idx_pstart, q_kmer, prefix_bits, window)
    else:
        return join.searchsorted_both(index_kmers, q_kmer)
    return tier2(lo, hi, uncovered, q_kmer, q_ok, index_kmers)


def tier2(lo, hi, uncovered, q_kmer, q_ok, index_kmers):
    """join_bounds' tier 2 as torch ops: the kept queries a lookup left
    uncovered are compacted (torch.nonzero, a host synchronisation),
    searched exactly in index_kmers, and their bounds put back in place
    (two out-of-place index_put copies).  Returns (lo, hi)."""
    sel = torch.nonzero(q_ok & (uncovered > 0)).reshape(-1)
    lo2, hi2 = join.searchsorted_both(index_kmers, q_kmer[sel])
    return lo.index_put((sel,), lo2), hi.index_put((sel,), hi2)


def expand_seeds(read_kmer, read_off, read_rc, read_valid, read_lengths,
                 index_kmers, idx_pack,
                 max_matches: Optional[int] = None,
                 capacity: Optional[int] = None, idx_pstart=None,
                 prefix_bits: int = 0, window: int = 0,
                 idx_rows=None, idx_pstart2=None,
                 idx_bucket=None, bucket_bits: int = 0,
                 idx_sector=None, sector_bits: int = 0):
    """Join + pair expansion (the first half of match_overlaps).

    read_kmer: int64 keys [N, W]; index_kmers: sorted int64 keys [M'],
    sentinel-padded (db/kmer_index.join_columns) when a prefix table is
    given; idx_pack: int64 [M'] words entry<<33 | offset<<1 | rc.
    max_matches=None: no per-k-mer fanout clip; capacity=None: exactly
    the number of emitted pairs.  Either cap, when given and smaller than
    the data, drops pairs and counts them into `overflow`, as the
    reference package does.

    The join is join_bounds with the table arguments.

    Returns (key1 int64 [cap], key2 int64 [cap], overflow int64 [],
    needed_capacity int64 [], max_fanout int32 [])."""
    n, w = read_kmer.shape
    if w > 1024:
        raise ValueError(
            f"read window w={w} (max_read_len={w + K - 1}) exceeds the "
            f"10-bit offset field of the packed expansion (w <= 1024)")
    dev = read_kmer.device
    q_kmer = read_kmer.reshape(-1)
    q_off = read_off.reshape(-1).to(torch.int64)
    q_rc = read_rc.reshape(-1)
    q_read = torch.arange(n, dtype=torch.int64,
                          device=dev).repeat_interleave(w)
    # pileups with k-mer == 0 are skipped entirely (Overlap.h:236-239)
    q_ok = read_valid.reshape(-1) & (q_kmer != FLIP)

    lo, hi = join_bounds(q_kmer, q_ok, index_kmers, idx_pstart=idx_pstart,
                         prefix_bits=prefix_bits, window=window,
                         idx_rows=idx_rows, idx_pstart2=idx_pstart2,
                         idx_bucket=idx_bucket, bucket_bits=bucket_bits,
                         idx_sector=idx_sector, sector_bits=sector_bits)
    matches = torch.where(q_ok, hi - lo, 0)
    clipped = matches if max_matches is None else \
        torch.clamp(matches, max=max_matches)
    cell_overflow = torch.sum(matches - clipped)
    needed = torch.sum(matches)
    fanout = torch.max(matches) if len(matches) else \
        torch.zeros((), dtype=torch.int64, device=dev)
    if capacity is None:
        capacity = max(int(torch.sum(clipped)), 1)
    if not 0 < capacity < 2**31:
        raise ValueError(f"capacity {capacity} must fit int32")

    # q side: read id | fwd offset | rc-space offset | rc  (both offset
    # variants precomputed so read_lengths needs no per-pair gather)
    q_lens = read_lengths.to(torch.int64)[:, None].expand(n, w).reshape(-1)
    off_rcspace = torch.clamp(q_lens - q_off - K, min=0)
    q_pack = ((q_read << 21) | (q_off << 11) | (off_rcspace << 1) |
              q_rc.to(torch.int64))

    key1, key2, cap_overflow, _ = _emit_pairs(
        lo, clipped, q_pack, idx_pack, idx_pack.shape[0], capacity)
    return (key1, key2, cell_overflow + cap_overflow, needed,
            fanout.to(torch.int32))


def finish_overlaps(key1, key2, overflow, needed_capacity,
                    max_fanout) -> Overlaps:
    """Sort + chained dedup over packed seed words from expand_seeds."""
    perm = lex_perm(key1, key2)
    key1, key2 = key1[perm], key2[perm]
    in_range = key1 != INT64_MAX
    r_id = torch.where(in_range, (key1 >> 32).to(torch.int32), INT32_MAX)
    e_id = torch.where(in_range, (key1 & 0xFFFFFFFF).to(torch.int32),
                       INT32_MAX)
    rel = torch.where(in_range, ((key2 >> 1) - 2**31).to(torch.int32),
                      INT32_MAX)
    rc = (key2 & 1).to(torch.bool)
    keep, count = chained_dedup_device(r_id, e_id, rel, in_range)
    return Overlaps(r_id, e_id, rel, rc, keep, count, overflow,
                    needed_capacity=needed_capacity, max_fanout=max_fanout)


def match_overlaps(read_kmer, read_off, read_rc, read_valid, read_lengths,
                   index_kmers, idx_pack,
                   max_matches: Optional[int] = None,
                   capacity: Optional[int] = None, **join_tables) -> Overlaps:
    """Full seeding stage: expand_seeds + finish_overlaps.  join_tables:
    expand_seeds' table arguments (idx_sector, sector_bits, idx_bucket,
    bucket_bits, idx_pstart, prefix_bits, window, idx_rows,
    idx_pstart2).
    Returns Overlaps sorted by (read, entry, relPos, rc), deduped."""
    seeds = expand_seeds(read_kmer, read_off, read_rc, read_valid,
                         read_lengths, index_kmers, idx_pack,
                         max_matches=max_matches, capacity=capacity,
                         **join_tables)
    return finish_overlaps(*seeds)


def chained_dedup_device(read_id, entry_id, rel, valid):
    """Exact chained |delta rel| < 3 dedup (Overlap.h:79-85) on rows
    sorted by (read, entry, rel).

    The reference keeps, per (read, entry) group, a greedy chain: the
    first distinct row, then each next distinct row whose rel is >= the
    last kept rel + 3.  Exact duplicates (same group and rel) are never
    kept.  Here every distinct row gets its successor (first row of its
    group with rel >= own rel + 3, one searchsorted over the sorted
    (group, rel) keys), and a row is kept iff the successor chain from a
    cluster head reaches it (pointer doubling, log2(P) rounds).  This is
    exact for clusters of any length, replacing the reference package's
    bounded Jacobi scan + oversized-cluster tail.

    Returns (keep mask, kept count int32 [])."""
    n = rel.shape[0]
    dev = rel.device
    if n == 0:
        return (torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))

    prev_rel = shift1(rel, INT32_MAX)
    same_group = (read_id == shift1(read_id, INT32_MAX)) & \
        (entry_id == shift1(entry_id, INT32_MAX))
    dup = same_group & (rel == prev_rel) & valid
    distinct = valid & ~dup
    is_head = distinct & (~same_group | (rel.to(torch.int64) -
                                         prev_rel.to(torch.int64) >= 3))

    # (group, rel) keys are nondecreasing; a duplicate shares its first
    # instance's key, so a left search always lands on a distinct row
    gid = torch.cumsum((~same_group).to(torch.int64), 0)
    bias = 2**31
    key = (gid << 33) + rel.to(torch.int64) + bias
    succ = torch.searchsorted(key, key + 3, right=False)
    s_ok = (succ < n) & (gid[torch.clamp(succ, max=n - 1)] == gid)
    succ = torch.where(s_ok & distinct, succ, n)

    # pointer doubling from the heads: after k rounds `reach` holds every
    # succ^j(head) with j < 2^k; slot n is a self-looping sink
    reach = torch.cat([is_head, torch.zeros(1, dtype=torch.bool,
                                            device=dev)])
    nxt = torch.cat([succ, torch.full((1,), n, dtype=succ.dtype,
                                      device=dev)])
    for _ in range(max(1, (n - 1).bit_length())):
        tgt = torch.where(reach[:n], nxt[:n], n)
        reach = reach.index_fill(0, tgt, True)
        nxt = nxt[nxt]
    keep = reach[:n] & distinct
    return keep, keep.sum().to(torch.int32)


def compact_overlaps(overlaps: Overlaps) -> Overlaps:
    """Move the kept rows to the front (stable) and drop the rest, so SW
    aligns exactly the candidates."""
    perm = torch.argsort((~overlaps.valid).to(torch.int8), stable=True)
    n = int(overlaps.count)
    metrics.count("sw_candidates", n)
    sel = perm[:n]
    return overlaps._replace(
        read_id=overlaps.read_id[sel], entry_id=overlaps.entry_id[sel],
        rel_pos=overlaps.rel_pos[sel], rc=overlaps.rc[sel],
        valid=overlaps.valid[sel])
