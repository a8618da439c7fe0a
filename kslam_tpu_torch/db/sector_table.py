"""The join's sector table: one 32 B row (one sector of the H100's L2
and DRAM traffic) per bucket of the sorted index keys, built from the
keys tensor on whatever device holds it.

It answers what the reference package's bucket table answers
(kslam_tpu/db/kmer_index.py KmerIndex.bucket_table, read by
kslam_tpu/ops/join.py:146-191 lookup_bucket): for a query word, the
insertion range of its word in the sorted keys, or, where the row cannot
say, the run of keys an exact search must look in (tier 2).  The
reference sized its row for the TPU (64 B, eight slots: one gather
transaction there); on the H100 the unit of traffic is a 32 B sector, so
a row here holds four slots and a query reads one sector.

Addressing is the reference's monotone CDF map (row_of): t = word >> 32,
v = 2t - floor(t^2 / 2^32), row = min(v >> (32 - bits), 2^bits - 1).
It is monotone in the word, so a row addresses a contiguous run
[start, start + count) of the sorted keys.

Row layout, int32 words:
  w0       the run's start
  w1       t_base, the first key's t (u32)
  w2..w5   the low 32 bits of the run's first four keys (slots 0..3)
  w6       the t-deltas of slots 0 and 1 (12 bits each, slot 1 at 12)
  w7       the t-deltas of slots 2 and 3, the count (3 bits at
           COUNT_SHIFT) and the escape bit (ESCAPE_SHIFT)
Slot s < count holds the word ((t_base + delta_s) << 32) | low_s.  A row
escapes when its run holds more than four keys or a key whose t lies
2^12 or more above t_base; an escaped row keeps w0, holds the run's
length in w2, the escape bit in w7 and zeros elsewhere, so tier 2
starts from the same sector.  An empty row is all zeros but w0.

The table counts the M real keys only: the sentinels that pad the keys
(db/kmer_index.join_columns) are in no row.

build is plain torch ops, deterministic on every device: the row index
is non-decreasing over the sorted keys, so each row's start is one
searchsorted of the rows it covers within a slice of keys, and every
write goes to its own row.  It runs over slices of keys, then of rows,
so its temporaries stay near SLICE_KEYS and SLICE_ROWS elements at any
size.  ops/join.lookup_sector reads the table (the sector_join kernel of
csrc/join.cu on the card).
"""

from __future__ import annotations

import torch

from ..ops.kmers import FLIP

ROW_WORDS = 8                    # int32 words a row: 32 B
SLOTS = 4                        # keys a covered row holds
DELTA_BITS = 12                  # bits of a slot's t-delta
COUNT_SHIFT = 24                 # w7: the count's 3 bits
ESCAPE_SHIFT = 27                # w7: the escape bit
MIN_BITS = 21                    # the reference's floor (module comment)
MAX_BITS = 27                    # 4 GiB of rows
U32 = 0xFFFFFFFF
SLICE_KEYS = 1 << 22             # keys per slice of the start pass
SLICE_ROWS = 1 << 20             # rows per slice of the slot pass
# default_bits' bound on a row's mean load: 5 rows for every 4 keys
ROWS_PER_KEY = (5, 4)


def default_bits(n_keys: int) -> int:
    """The table's bits for n_keys keys: the fewest rows that hold at
    most 1.25 keys each on average (2^bits >= 0.8 n_keys), clamped to
    MIN_BITS..MAX_BITS.  The measured rule it encodes (the fused
    join_bounds on the H100 after an L2 flush, PERF.md §6): of the sizes
    tried, the smallest whose time lies within the spread of the
    fastest's.  Over 1e8 uniform keys that is 2^27 rows (2^26 is ~3%
    slower, outside the spread; 2^25 ~23%), over 1.03e7 repeat-rich keys
    2^23 rows (2^24 the fastest, 2^22 ~11% slower).  The floor of 21 bits,
    the reference's, keeps a row's t-span (~2^(33 - bits) at the low
    end) within the 12-bit t-delta field."""
    rows, keys = ROWS_PER_KEY
    need = -(-keys * n_keys // rows)         # ceil(0.8 n_keys)
    bits = max(need - 1, 1).bit_length()
    return min(max(bits, MIN_BITS), MAX_BITS)


def row_of(keys, bits: int):
    """The row of each key (int64 in the ops/kmers.py encoding) under the
    CDF map, as int64.  t * t (t < 2^32) is split into 16-bit halves so
    its floor is exact on int64."""
    word = keys ^ FLIP
    t = (word >> 32) & U32
    th, tl = t >> 16, t & 0xFFFF
    # floor(t^2 / 2^32) with t = th * 2^16 + tl: th^2 plus the floor of
    # the low part, which is < 2^50
    sq = th * th + ((((th * tl) << 17) + tl * tl) >> 32)
    v = (t << 1) - sq
    return torch.clamp(v >> (32 - bits), max=(1 << bits) - 1)


def _as_i32(x):
    """int64 values in [0, 2^32) as the int32 of the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def build(keys, n_keys: int, bits: int, slice_keys: int = SLICE_KEYS,
          slice_rows: int = SLICE_ROWS):
    """The int32 [2^bits, 8] sector table of the first n_keys of the
    sorted int64 keys (ops/kmers.py encoding), on the keys' device."""
    if not 1 <= bits <= 32:
        raise ValueError(f"sector bits {bits} not in 1..32")
    if keys.dim() != 1 or keys.dtype != torch.int64 or \
            not 0 <= n_keys <= keys.shape[0] or n_keys >= 2**31:
        raise ValueError(f"sector table keys: {keys.dtype} "
                         f"{tuple(keys.shape)} with {n_keys} real keys")
    dev = keys.device
    n_rows = 1 << bits
    tbl = torch.zeros((n_rows, ROW_WORDS), dtype=torch.int32, device=dev)
    if n_keys == 0:
        return tbl
    start = tbl[:, 0]
    # each row's start: the keys in rows below it.  A slice [i, j) owns
    # the rows after the previous slice's last row up to its own last
    # row; every key before i is in a lower row and every key from j on
    # in a row at or above it, so start = i + the slice's keys below it
    done = 0
    for i in range(0, n_keys, slice_keys):
        rows = row_of(keys[i:min(i + slice_keys, n_keys)], bits)
        last = int(rows[-1]) + 1
        if last > done:
            r = torch.arange(done, last, dtype=torch.int64, device=dev)
            start[done:last] = (torch.searchsorted(rows, r) + i) \
                .to(torch.int32)
            done = last
    start[done:] = n_keys

    slots = torch.arange(SLOTS, dtype=torch.int64, device=dev)
    for r0 in range(0, n_rows, slice_rows):
        r1 = min(r0 + slice_rows, n_rows)
        s = tbl[r0:r1, 0].to(torch.int64)
        end = tbl[r0 + 1:r1 + 1, 0].to(torch.int64)
        if r1 == n_rows:
            end = torch.cat([end, end.new_full((1,), n_keys)])
        cnt = end - s
        in_run = slots[None, :] < cnt[:, None]
        # the run's first four keys (clamped reads past it are masked)
        at = torch.clamp(s[:, None] + slots[None, :], max=n_keys - 1)
        word = keys[at] ^ FLIP
        t = (word >> 32) & U32
        delta = torch.where(in_run, t - t[:, :1], 0)
        escape = (cnt > SLOTS) | (delta >= (1 << DELTA_BITS)).any(1)
        keep = in_run & ~escape[:, None]
        low = torch.where(keep, word & U32, 0)
        delta = torch.where(keep, delta, 0)
        t_base = torch.where(escape | (cnt == 0), 0, t[:, 0])
        tbl[r0:r1, 1] = _as_i32(t_base)
        tbl[r0:r1, 2:6] = _as_i32(low)
        tbl[r0:r1, 2] = torch.where(escape, cnt.to(torch.int32),
                                    tbl[r0:r1, 2])
        tbl[r0:r1, 6] = (delta[:, 0] | (delta[:, 1] << DELTA_BITS)) \
            .to(torch.int32)
        tbl[r0:r1, 7] = (delta[:, 2] | (delta[:, 3] << DELTA_BITS) |
                         (torch.where(escape, 0, cnt) << COUNT_SHIFT) |
                         (escape.to(torch.int64) << ESCAPE_SHIFT)) \
            .to(torch.int32)
    return tbl
