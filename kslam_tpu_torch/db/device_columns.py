"""The database's device columns, derived on the device from the loaded
index and genome arrays.

pipeline/align.DeviceDB.from_index holds these tensors, and
parallel/dist.place_sharded_db holds them per mesh cell.  They equal, bit
for bit, the host versions the tests hold them to:

  * index_columns = db/kmer_index.join_columns: the sorted keys
    (ops/kmers.py encoding) and the per-slot word entry<<33 | offset<<1 |
    rc, padded to cap = pow2(M + max(2*window, 1)) with the all-ones
    sentinel (int64 max) and 0, and the prefix table
    (KmerIndex.prefix_table: pstart, bits, window);
  * genome_rows = ops/sw.genome_chunks_from_scodes(ops/encode.sw_codes_np(
    bases)): the SW codes as [ceil(G/32), 32] rows padded with N.

What goes up is the raw columns: the u64 words straight into the key
buffer, where their top bit is flipped in place; entry/offset/rc a staged
chunk at a time, each folded into idx_pack as it lands (the three raw
columns are never whole on the device); the ASCII bases into the padded
row buffer, mapped to SW codes in place a slice at a time.  The copies go
through a small ring of host buffers (pinned on a card: the host fills
one while the device copies from the others, an event per buffer saying
when it may be refilled), so host memory stays flat for a memmapped
index.

The prefix table's counts are a histogram of the keys' top bits on the
device; its rule (which widths, the longest run, the 99.9th percentile of
the occupied counts, the rounding) is the host copy's arithmetic, run on
the host on one max or, in the percentile branch only, on the fetched
counts.  choose_prefix takes the counts as a function of the width, so a
mesh sums them over its shards (place_sharded_db) and no device ever
holds the whole key column.

A failure raises; nothing here falls back to the host versions.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..ops import encode
from ..ops.kmers import FLIP
from ..ops.sw import CHUNK
from ..utils.logging import log

SENTINEL = (1 << 63) - 1         # the all-ones word's key
MAX_WINDOW = 128                 # KmerIndex.prefix_table's max_window
MAX_BITS = 26                    # and its max_bits
STAGE_BYTES = 64 << 20           # bytes of one host staging buffer
RING = 4                         # staging buffers
SLICE = 1 << 24                  # elements a slice of the device passes

_TORCH = {np.dtype(np.int64): torch.int64, np.dtype(np.int32): torch.int32,
          np.dtype(np.uint8): torch.uint8, np.dtype(bool): torch.bool}


def _untimed(name: str):
    return contextlib.nullcontext()


class Stager:
    """Host -> device copies of 1-D numpy arrays in chunks of STAGE_BYTES
    through RING host buffers (pinned when the device is a card, where
    the copies are non-blocking and each buffer's event, recorded after
    its copy, is waited for before the host refills it).  On the CPU the
    same chunks go through plain buffers."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.buffers = []
        self.events = [None] * RING
        self.turn = 0

    def _staged(self, src: np.ndarray):
        """(src (at most STAGE_BYTES) in the next host buffer, the
        buffer's slot)."""
        slot = self.turn % RING
        self.turn += 1
        if slot == len(self.buffers):
            self.buffers.append(torch.empty(STAGE_BYTES, dtype=torch.uint8,
                                            pin_memory=self.cuda))
        if self.events[slot] is not None:
            self.events[slot].synchronize()
        host = self.buffers[slot][:src.nbytes]
        np.copyto(host.numpy(), np.ascontiguousarray(src).view(np.uint8))
        return host.view(_TORCH[src.dtype]), slot

    def put(self, src: np.ndarray, dst: torch.Tensor = None) -> torch.Tensor:
        """One chunk src onto the device, into dst (len(src) elements of
        src's dtype) or a new tensor; returns it."""
        host, slot = self._staged(src)
        if dst is None:
            dst = torch.empty(len(src), dtype=host.dtype, device=self.device)
        dst.copy_(host, non_blocking=self.cuda)
        if self.cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.events[slot] = ev
        return dst

    def copy(self, src: np.ndarray, dst: torch.Tensor) -> None:
        """dst[:len(src)] <- src, a chunk at a time."""
        step = max(STAGE_BYTES // src.itemsize, 1)
        for a in range(0, len(src), step):
            chunk = src[a:a + step]
            self.put(chunk, dst[a:a + len(chunk)])

    def chunks(self, *srcs: np.ndarray):
        """Yields (a, b, the device chunks [a, b) of each of srcs)."""
        step = max(STAGE_BYTES // max(s.itemsize for s in srcs), 1)
        n = len(srcs[0])
        for a in range(0, n, step):
            b = min(a + step, n)
            yield a, b, [self.put(s[a:b]) for s in srcs]


def join_cap(m: int, window: int) -> int:
    """The padded length of join_columns' columns: pow2(M + max(2*window,
    1))."""
    return 1 << max(m + max(2 * window, 1) - 1, 1).bit_length()


def upload_keys(words, device, cap: int, stage=_untimed) -> torch.Tensor:
    """An int64 [cap] buffer on `device` whose first len(words) entries
    are the keys of the u64 `words` (their top bit flipped in place); the
    tail is unset."""
    words = np.asarray(words, np.uint64).view(np.int64)
    buf = torch.empty(cap, dtype=torch.int64, device=device)
    with stage("db_load_h2d"):
        Stager(device).copy(words, buf)
    with stage("db_load_columns"):
        buf[:len(words)] ^= FLIP
    return buf


def seal_keys(buf: torch.Tensor, m: int, cap: int) -> torch.Tensor:
    """buf cut to cap entries (a copy when shorter, so the rest is freed)
    with the sentinel from m on."""
    keys = buf if cap == buf.shape[0] else buf[:cap].clone()
    keys[m:] = SENTINEL
    return keys


def pack_column(entry_id, offset, rc, cap: int, device,
                stage=_untimed) -> torch.Tensor:
    """idx_pack int64 [cap]: entry<<33 | offset<<1 | rc for the first
    len(entry_id) slots, formed from each staged chunk as it lands; 0
    in the tail."""
    pack = torch.zeros(cap, dtype=torch.int64, device=device)
    with stage("db_load_h2d"):
        for a, b, (e, o, r) in Stager(device).chunks(
                np.asarray(entry_id), np.asarray(offset), np.asarray(rc)):
            pack[a:b] = (e.to(torch.int64) << 33) | \
                (o.to(torch.int64) << 1) | r.to(torch.int64)
    return pack


def prefix_counts(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """int32 [2^bits]: how many of `keys` have each top-`bits` prefix of
    their u64 word, ((key >> (64 - bits)) & mask) ^ 2^(bits - 1) (the
    arithmetic shift fills the top with the key's sign, which the mask
    drops; the xor undoes the key's flipped top bit)."""
    nb = 1 << bits
    counts = torch.zeros(nb, dtype=torch.int32, device=keys.device)
    one = torch.ones(1, dtype=torch.int32, device=keys.device)
    for a in range(0, keys.shape[0], SLICE):
        top = ((keys[a:a + SLICE] >> (64 - bits)) & (nb - 1)) ^ (nb >> 1)
        counts.index_add_(0, top, one.expand(top.shape[0]))
    return counts


def _starts(counts: torch.Tensor) -> torch.Tensor:
    pstart = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                         device=counts.device)
    torch.cumsum(counts, 0, dtype=torch.int32, out=pstart[1:])
    return pstart


def choose_prefix(counts_of, m: int, max_window: int = MAX_WINDOW,
                  max_bits: int = MAX_BITS):
    """KmerIndex.prefix_table's choice over an index of m keys whose
    prefix counts at a width are counts_of(bits) (int32 on a device):
    (pstart int32 [2^bits + 1] on that device, bits, window), or (None,
    0, 0).  The widths tried, the longest run (one max on the device),
    the 99.9th percentile of the occupied counts (np.percentile on the
    fetched counts, only when the longest run does not fit) and the
    rounding are the copy's arithmetic."""
    start_bits = min(max(8, (max(m, 2) - 1).bit_length()), max_bits)
    partial = None
    for bits in sorted(set(range(start_bits, max_bits + 1, 2)) |
                       {max_bits}):
        counts = counts_of(bits)
        longest = int(counts.max()) if m else 0
        if longest <= max_window:
            window = max(8, 1 << int(longest - 1).bit_length()) \
                if longest > 1 else 8
            return _starts(counts), bits, window
        if partial is None:
            host = counts.cpu().numpy()
            occupied = host[host > 0].astype(np.int64)
            p999 = float(np.percentile(occupied, 99.9)) \
                if len(occupied) else 0.0
            if p999 <= max_window:
                window = max(8, 1 << int(max(p999, 1) - 1).bit_length())
                partial = (_starts(counts), bits, window)
        del counts
    if partial is not None:
        log(f"prefix table: heavy-tail runs exceed window="
            f"{partial[2]} at {partial[1]} bits; queries in those "
            f"runs take the exact retry path")
        return partial
    log(f"WARNING: longest k-mer prefix run exceeds {max_window} even "
        f"at {max_bits} prefix bits (pathologically repetitive "
        f"database); the join falls back to the slower blocked "
        f"binary search")
    return None, 0, 0


def prefix_table_device(keys: torch.Tensor, m: int):
    """KmerIndex.prefix_table() of the index whose first m sorted keys
    are `keys`: (pstart int32 on keys' device or None, bits, window)."""
    return choose_prefix(lambda bits: prefix_counts(keys[:m], bits), m)


def index_columns(kidx, device, stage=_untimed):
    """join_columns(kidx) on `device`: (keys int64 [cap], idx_pack int64
    [cap], pstart int32 or None, bits, window).  The keys go up first
    into a buffer sized for the widest window the prefix rule can pick,
    since cap depends on the window it picks.  `stage(name)` times each
    part (db_load_h2d, db_load_columns)."""
    m = len(kidx.kmers)
    buf = upload_keys(kidx.kmers, device, join_cap(m, MAX_WINDOW), stage)
    with stage("db_load_columns"):
        pstart, bits, window = prefix_table_device(buf, m)
        cap = join_cap(m, window)
        keys = seal_keys(buf, m, cap)
        del buf
    pack = pack_column(kidx.entry_id, kidx.offset, kidx.rc, cap, device,
                       stage)
    return keys, pack, pstart, bits, window


def genome_rows(bases, device, flat: bool = False, length: int = None,
                stage=_untimed):
    """sw.genome_chunks_from_scodes(encode.sw_codes_np(bases)) on
    `device`: uint8 [ceil(n/32), 32] with n = length (>= len(bases);
    default len(bases)), the codes of `bases` then N.  With flat, also
    the [len(bases)] codes as a view of the same buffer.  The ASCII bases
    go up into the row buffer, the tail is filled with a byte that maps
    to N, and the buffer is mapped in place by encode.sw_codes one slice
    at a time (it widens to int32 and int64 temporaries)."""
    bases = np.asarray(bases, np.uint8)
    g = len(bases)
    n = g if length is None else length
    buf = torch.empty(-(-n // CHUNK) * CHUNK, dtype=torch.uint8,
                      device=device)
    with stage("db_load_h2d"):
        Stager(device).copy(bases, buf)
    with stage("db_load_columns"):
        buf[g:] = ord("N")
        for a in range(0, buf.shape[0], SLICE):
            part = buf[a:a + SLICE]
            part.copy_(encode.sw_codes(part))
    rows = buf.view(-1, CHUNK)
    return (rows, buf[:g]) if flat else rows
