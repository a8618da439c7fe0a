"""The bytes a sector_join launch (csrc/join.cu, match.join_bounds with
the sector table and tier 2 fused) needs, each input read once and each
output written once, as PERF.md counts them:

  * 8 B a query key and 16 B a query's lo and hi;
  * 32 B a distinct table row the queries fall in (one sector);
  * 1 B of q_ok a query whose row escapes (the kernel reads it there);
  * 8 B a distinct index key tier 2's binary searches read (the
    escaped, kept queries with a non-empty run), as exact_bounds
    searches: the lower bound in [start, end), then the upper bound
    from it (to the keys' end for the all-ones word).

Everything comes from the cell's own reads and the generated index: the
row map (the reference's CDF map) and a row's escape (more than four
keys, or a key whose t lies 2^12 or more above the first's) are worked
out here from the sorted keys, not read from the program's table.
"""

from __future__ import annotations

import numpy as np
import torch

FLIP = -(1 << 63)
ALL_ONES_KEY = 2**63 - 1
U32 = 0xFFFFFFFF
SLOTS = 4
DELTA_LIMIT = 1 << 12


def default_bits(n_keys: int) -> int:
    """The table's rows for n_keys keys: the fewest holding at most 1.25
    keys each, 21..27 bits (db/sector_table.default_bits' rule)."""
    need = -(-4 * n_keys // 5)
    return min(max(max(need - 1, 1).bit_length(), 21), 27)


def row_of(keys, bits: int):
    """The CDF map of int64 keys: t = word >> 32, v = 2t - floor(t^2 /
    2^32), row = min(v >> (32 - bits), 2^bits - 1)."""
    t = ((keys ^ FLIP) >> 32) & U32
    th, tl = t >> 16, t & 0xFFFF
    sq = th * th + ((((th * tl) << 17) + tl * tl) >> 32)
    return torch.clamp(((t << 1) - sq) >> (32 - bits), max=(1 << bits) - 1)


def probes(keys, a, b, q):
    """Every position tier 2's two binary searches read."""
    n = keys.shape[0]
    b = torch.clamp(b, max=n)
    seen = [a.new_zeros(0)]

    def search(a, b, upper):
        a, b = a.clone(), b.clone()
        while bool((a < b).any()):
            live = a < b
            mid = a + ((b - a) >> 1)
            x = keys[torch.where(live, mid, 0)]
            seen.append(mid[live])
            go = live & ((x <= q) if upper else (x < q))
            a = torch.where(go, mid + 1, a)
            b = torch.where(live & ~go, mid, b)
        return a

    lo = search(a, b, False)
    rest = q != ALL_ONES_KEY
    search(lo[rest], b[rest], True) if bool(rest.any()) else None
    return torch.cat(seen)


def join_bytes(queries, q_ok, keys, key_rows, bits: int) -> int:
    """The bytes one launch needs: queries int64 [Q] (keys, ops/kmers.py
    encoding), q_ok bool [Q], keys the sorted index keys [M] and
    key_rows = row_of(keys, bits)."""
    n_q = queries.numel()
    row = row_of(queries, bits)
    rows = int(torch.unique(row).numel())
    start = torch.searchsorted(key_rows, row, right=False)
    end = torch.searchsorted(key_rows, row, right=True)
    cnt = end - start
    m = keys.shape[0]
    t = ((keys ^ FLIP) >> 32) & U32
    first = t[torch.clamp(start, max=m - 1)]
    last = t[torch.clamp(start + torch.clamp(cnt, max=SLOTS) - 1, 0, m - 1)]
    escaped = (cnt > SLOTS) | ((cnt > 0) & (last - first >= DELTA_LIMIT))
    t2 = q_ok & escaped
    pos = probes(keys, start[t2], end[t2], queries[t2])
    return (n_q * 24 + rows * 32 + int(escaped.sum()) +
            int(torch.unique(pos).numel()) * 8)


def batch_queries(r1: np.ndarray, r2: np.ndarray, pad: int, rows: int,
                  device):
    """(keys, q_ok) of one device batch, as the program forms them:
    `rows` R1 rows then `rows` R2 rows (rows past the reads empty), each
    padded to `pad` with non-bases (code 0), a k-mer at every position."""
    from portbench.reference.seeds import FLIP as F, read_kmers
    n, rl = r1.shape
    reads = np.zeros((2 * rows, pad), np.uint8)
    reads[:n, :rl] = r1
    reads[rows:rows + n, :rl] = r2
    lut = np.zeros(256, np.uint8)
    for c, v in zip(b"ACTG", range(4)):
        lut[c] = v
    codes = torch.as_tensor(lut[reads]).to(device)
    lengths = torch.zeros(2 * rows, dtype=torch.int32, device=device)
    lengths[:n] = rl
    lengths[rows:rows + n] = rl
    key, _, _, valid = read_kmers(codes, lengths)
    key = key.reshape(-1)
    return key, valid.reshape(-1) & (key != F)


def batch_bytes(run, file_chunk: int, batch: int) -> int:
    """join_bytes of device batch `batch` of file chunk `file_chunk` of
    the run's FASTQ pair (cached on the run)."""
    cache = run.__dict__.setdefault("_sector_join_bytes", {})
    key = (file_chunk, batch)
    if key not in cache:
        if "_sector_keys" not in run.__dict__:
            words = np.asarray(run.host["index"][0], np.uint64)
            keys = torch.as_tensor((words ^ np.uint64(1 << 63))
                                   .view(np.int64)).to(run.device)
            bits = default_bits(keys.shape[0])
            run._sector_keys = (keys, row_of(keys, bits), bits)
        keys, key_rows, bits = run._sector_keys
        unit = run.config.read_batch // 2
        chunk = run.config.num_reads_at_once
        lo = file_chunk * chunk + batch * unit
        hi = min(lo + unit, (file_chunk + 1) * chunk,
                 run.host["r1"].shape[0])
        q, ok = batch_queries(run.host["r1"][lo:hi], run.host["r2"][lo:hi],
                              run.pad, unit, run.device)
        cache[key] = join_bytes(q, ok, keys, key_rows, bits)
    return cache[key]
