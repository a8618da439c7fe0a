"""Presorted, shardable canonical k-mer index over a genome database.

This replaces the reference's runtime strategy of appending genome k-mers to
the read k-mer vector and sorting the union (SLAM.h:63-66, KMer.h:388-398,
the ~50GB RAM peak).  The index is built offline, sorted once by k-mer
value, and persisted; at runtime read k-mers are merge-joined against it by
vectorized binary search (ops/match.py).

Layout (struct-of-arrays, device friendly):
  kmers    uint64 [M]   sorted ascending
  entry_id int32  [M]   genome entry (position in GenbankIndex.entries)
  offset   int32  [M]   forward k-mer start within the entry
  rc       bool   [M]   canonical form is the reverse complement

The join's tables (prefix_table, bucket_table) are built here on the
host, as in the reference package, and bucket_table shares its cache
files (bucket_table.npy, bucket_meta.json in the DB directory) with it.
join_columns gives the padded columns in the port's key encoding
(ops/kmers.py) on the host: the plain version that db/device_columns.py,
which pipeline/align.DeviceDB.from_index and parallel/dist.place_sharded_db
load through, derives on the device bit for bit.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from ..config import GENOME_KMER_GAP
from ..ops import kmers as kmer_ops
from .genbank import GenbankIndex


def index_words_np(kmer_words, entry_id, offset, rc):
    """The join's two index columns as int64 host arrays: the sorted
    k-mer keys (ops/kmers.py key encoding) and the per-slot word
    entry<<33 | offset<<1 | rc."""
    keys = kmer_ops.keys_from_words_np(kmer_words)
    pack = ((np.asarray(entry_id).astype(np.uint64) << np.uint64(33))
            | (np.asarray(offset).astype(np.uint64) << np.uint64(1))
            | np.asarray(rc).astype(np.uint64)).view(np.int64)
    return keys, pack


def join_columns(kidx):
    """The join's host columns of `kidx`, padded for the device: (keys
    int64 [cap], idx_pack int64 [cap], pstart, prefix_bits, window),
    with pstart, prefix_bits and window those of kidx.prefix_table().
    Keys are in the ops/kmers.py encoding and their tail is the all-ones
    sentinel (int64 max); idx_pack's tail is 0.  cap = pow2(M +
    max(2*window, 1)), the padding of the reference package's
    KmerIndex.device_arrays, so the window join's aligned two-row read
    never runs past the end."""
    pstart, bits, window = kidx.prefix_table()
    m = len(kidx.kmers)
    cap = 1 << max(m + max(2 * window, 1) - 1, 1).bit_length()
    keys = np.full(cap, np.iinfo(np.int64).max, np.int64)
    pack = np.zeros(cap, np.int64)
    keys[:m], pack[:m] = index_words_np(kidx.kmers, kidx.entry_id,
                                        kidx.offset, kidx.rc)
    return keys, pack, pstart, bits, window


class KmerIndex:
    def __init__(self, kmers: np.ndarray, entry_id: np.ndarray,
                 offset: np.ndarray, rc: np.ndarray):
        self.kmers = kmers
        self.entry_id = entry_id
        self.offset = offset
        self.rc = rc
        #: directory for derived-artifact caching (bucket table); set by
        #: load()/load_npy(), or assignable by callers with their own cache
        self.cache_dir = None
        self._bucket = None

    def __len__(self) -> int:
        return len(self.kmers)

    @classmethod
    def build(cls, index: GenbankIndex,
              gap: int = GENOME_KMER_GAP) -> "KmerIndex":
        """Genome k-mers every `gap` bases (SLAM.h:65 uses gap = k/2)."""
        parts = []
        for i, entry in enumerate(index.entries):
            ascii_bytes = np.frombuffer(entry.bases.encode(), dtype=np.uint8)
            km, off, rc = kmer_ops.sequence_kmers_np(ascii_bytes, gap)
            parts.append((km, np.full(len(km), i, dtype=np.int32), off, rc))
        if parts:
            km = np.concatenate([p[0] for p in parts])
            eid = np.concatenate([p[1] for p in parts])
            off = np.concatenate([p[2] for p in parts])
            rc = np.concatenate([p[3] for p in parts])
        else:
            km = np.zeros(0, np.uint64)
            eid = off = np.zeros(0, np.int32)
            rc = np.zeros(0, bool)
        # Sort by k-mer value; ties by (rc desc, entry desc, offset desc) to
        # mirror the reference's ID_isFromGB_RC-descending tie order within
        # pileups (KMer.h:388-398).  Pair emission order is normalized again
        # by the overlap sort, so this only pins down determinism.  The tie
        # keys ride one u64 (rc:1 | eid:31 | off:31, all < 2^31), so the
        # lexsort runs 2 stable passes instead of 4 -- the build is
        # host-bound at realistic index sizes.
        tie = ((rc.astype(np.uint64) << np.uint64(62)) |
               (eid.astype(np.uint64) << np.uint64(31)) |
               off.astype(np.uint64))
        order = np.lexsort((~tie, km))
        return cls(km[order], eid[order], off[order], rc[order])

    @classmethod
    def build_streamed(cls, entries_iter, out_dir: str,
                       gap: int = GENOME_KMER_GAP, bucket_bits: int = 6,
                       tmp_dir: str = None) -> "KmerIndex":
        """Out-of-core index build with bounded RAM (SURVEY 7.2 step 2 at
        config[3] scale: ~12 Gbp GenBank bacteria -> ~7.5e8 stride-16
        k-mers = ~13 GB of unsorted columns, which the in-RAM `build` +
        lexsort would double again; GenbankTools.h:481-527 is the
        reference workflow this replaces).

        Streams (entry_id, ascii uint8 bases) pairs; per entry the k-mers
        are split by their top `bucket_bits` VALUE prefix and appended to
        2^bucket_bits spill files (prefix buckets never split a pileup, so
        per-bucket sorts concatenated in prefix order reproduce the global
        sort + tie order exactly).  Peak RAM = one entry's k-mer columns +
        one bucket (~total/2^bucket_bits * 17B * lexsort factor).  The
        sorted columns are written straight into .npy memmaps under
        `out_dir` (the `save_npy` layout `load` already understands).

        Returns a memmap-backed KmerIndex."""
        import shutil
        import tempfile
        record = np.dtype([("km", np.uint64), ("eid", np.int32),
                           ("off", np.int32), ("rc", np.uint8)])
        nb = 1 << bucket_bits
        shift = np.uint64(64 - bucket_bits)
        work = tempfile.mkdtemp(prefix="kslam_idx_", dir=tmp_dir)
        files = [open(os.path.join(work, f"b{b:04d}.bin"), "wb")
                 for b in range(nb)]
        counts = np.zeros(nb, np.int64)
        try:
            for eid, ascii_bytes in entries_iter:
                km, off, rc = kmer_ops.sequence_kmers_np(ascii_bytes, gap)
                if not len(km):
                    continue
                rows = np.empty(len(km), record)
                rows["km"], rows["off"], rows["rc"] = km, off, rc
                rows["eid"] = eid
                b = (km >> shift).astype(np.int64)
                order = np.argsort(b, kind="stable")
                rows = rows[order]
                b_sorted = b[order]
                bounds = np.searchsorted(b_sorted, np.arange(nb + 1))
                for bk in np.unique(b_sorted):
                    lo, hi = bounds[bk], bounds[bk + 1]
                    files[bk].write(rows[lo:hi].tobytes())
                    counts[bk] += hi - lo
            for f in files:
                f.close()
            total = int(counts.sum())
            os.makedirs(out_dir, exist_ok=True)
            outs = {
                "kmers": np.lib.format.open_memmap(
                    os.path.join(out_dir, "kmers.npy"), mode="w+",
                    dtype=np.uint64, shape=(total,)),
                "entry_id": np.lib.format.open_memmap(
                    os.path.join(out_dir, "entry_id.npy"), mode="w+",
                    dtype=np.int32, shape=(total,)),
                "offset": np.lib.format.open_memmap(
                    os.path.join(out_dir, "offset.npy"), mode="w+",
                    dtype=np.int32, shape=(total,)),
                "rc": np.lib.format.open_memmap(
                    os.path.join(out_dir, "rc.npy"), mode="w+",
                    dtype=bool, shape=(total,)),
            }
            pos = 0
            for b in range(nb):
                if not counts[b]:
                    continue
                rows = np.fromfile(os.path.join(work, f"b{b:04d}.bin"),
                                   record)
                # same key order as build(): kmer asc, tie (rc, eid, off)
                # DESC to mirror the reference's ID_isFromGB_RC-descending
                # pileup order (KMer.h:388-398)
                tie = ((rows["rc"].astype(np.uint64) << np.uint64(62)) |
                       (rows["eid"].astype(np.uint64) << np.uint64(31)) |
                       rows["off"].astype(np.uint64))
                order = np.lexsort((~tie, rows["km"]))
                rows = rows[order]
                n = len(rows)
                outs["kmers"][pos:pos + n] = rows["km"]
                outs["entry_id"][pos:pos + n] = rows["eid"]
                outs["offset"][pos:pos + n] = rows["off"]
                outs["rc"][pos:pos + n] = rows["rc"].astype(bool)
                pos += n
            assert pos == total
            for v in outs.values():
                v.flush()
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return cls.load_npy(out_dir, mmap=True)

    @classmethod
    def load_npy(cls, directory: str, mmap: bool = False) -> "KmerIndex":
        mode = "r" if mmap else None
        out = cls(*(np.load(os.path.join(directory, f"{n}.npy"),
                            mmap_mode=mode)
                    for n in ("kmers", "entry_id", "offset", "rc")))
        out.cache_dir = directory
        return out

    # --- prefix direct-addressing table (ops/join.lookup_prefix_window) ---

    def prefix_table(self, max_window: int = 128,
                     max_bits: int = 26) -> Tuple[np.ndarray, int, int]:
        """(pstart, prefix_bits, window) for O(1) join addressing.

        Picks the smallest prefix width whose longest prefix-run fits
        `max_window`, so the device join gathers one small [Q, window]
        slice per query instead of binary-searching.  The window must stay
        small: the join materializes a [Q, window] u64 temp (~16 MB per
        window element at Q=2M), so the search starts near log2(M) where
        runs are already short.  pstart[p] = insertion point of prefix p
        (int32 [2^bits + 1], monotone).  window is the longest run rounded
        up to a power of two (>= 8).

        Real genome databases have a heavy run-length tail (homopolymer /
        microsatellite k-mers repeat thousands of times), so full coverage
        at `max_window` is often impossible.  In that case the table is
        sized so that >= 99.9% of prefix runs fit (`window = max_window`),
        and the join reports queries in longer runs as `uncovered`
        (ops/join.lookup_prefix_*); the pipeline's emit-all retry re-joins
        those exactly via the blocked search (pipeline/run.py).  Only when
        even the 99.9th-percentile run exceeds `max_window` at `max_bits`
        (the database is pathologically repetitive and the fast path would
        overflow constantly) does this warn and return (None, 0, 0)."""
        m = len(self.kmers)
        start_bits = min(max(8, (max(m, 2) - 1).bit_length()), max_bits)
        # step by 2 for speed but always include max_bits itself, even when
        # (max_bits - start_bits) is odd — otherwise the widest table is
        # never tried and the prefix join is skipped unnecessarily
        partial = None
        for bits in sorted(set(range(start_bits, max_bits + 1, 2)) |
                           {max_bits}):
            tops = (self.kmers >> np.uint64(64 - bits)).astype(np.int64)
            counts = np.bincount(tops, minlength=1 << bits)
            longest = int(counts.max()) if m else 0
            if longest <= max_window:
                pstart = np.zeros((1 << bits) + 1, np.int32)
                np.cumsum(counts, out=pstart[1:])
                window = max(8, 1 << int(longest - 1).bit_length()) \
                    if longest > 1 else 8
                return pstart, bits, window
            if partial is None:
                occupied = counts[counts > 0]
                p999 = float(np.percentile(occupied, 99.9)) \
                    if len(occupied) else 0.0
                if p999 <= max_window:
                    pstart = np.zeros((1 << bits) + 1, np.int32)
                    np.cumsum(counts, out=pstart[1:])
                    window = max(8, 1 << int(max(p999, 1) - 1).bit_length())
                    partial = (pstart, bits, window)
        if partial is not None:
            from ..utils.logging import log
            log(f"prefix table: heavy-tail runs exceed window="
                f"{partial[2]} at {partial[1]} bits; queries in those "
                f"runs take the exact retry path")
            return partial
        from ..utils.logging import log
        log(f"WARNING: longest k-mer prefix run exceeds {max_window} even "
            f"at {max_bits} prefix bits (pathologically repetitive "
            f"database); the join falls back to the slower blocked "
            f"binary search")
        return None, 0, 0

    # --- one-gather bucket table (ops/join.lookup_bucket) ---

    BUCKET_SLOTS = 8
    BUCKET_DELTA_BITS = 12
    BUCKET_TABLE_VERSION = 2   # bump when the CDF map / row layout changes

    def bucket_table(self, bits: int = None):
        """[2^bits, 16] int32 rows for the one-gather device join.

        Measured cost model (benches/probe_gather.py, v5e): random row
        gathers cost per ~64B transaction, u64 pays 2 int32 planes, so the
        two-gather prefix-rows join (~9 transactions/query) runs ~191 ms
        per 2.1M queries while ONE 64-byte int32 row runs ~52 ms.  This
        table packs everything the join needs into one such row.

        Addressing: canonical k-mers are min(fwd, rc), so their value
        density is ~2(1-u) -- top-bits bucketing overflows low buckets 7x
        (measured 25% hot mass at 2^25 top-bits vs 1.2% equalized).  The
        bucket of k-mer x is therefore the integer CDF map
            t = x >> 32;  v = 2t - floor(t^2 / 2^32)   in [0, 2^32]
            bucket = min(v >> (32 - bits), 2^bits - 1)
        (v peaks at exactly 2^32 when t = 2^32 - 1, hence the clamp for
        that single edge value) which is monotone in x, so buckets are
        contiguous runs of the sorted index and a (start, count) pair
        addresses them.  ops/join.lookup_bucket applies the identical map
        at query time.

        Row layout (int32 lanes):
          c0 start, c1 count | ESCAPE(1<<30), c2 t_base (u32 bitcast),
          c3..c6 eight 12-bit t-deltas (2 per word), c7..c14 eight low-32
          words, c15 spare.
        Buckets with count > 8 or a t-delta >= 2^12 set ESCAPE; their
        queries are resolved by the exact in-program tier-2 search
        (ops/match.expand_seeds) -- 1.2% of k-mer mass at bits=26 on a
        1e8 index (measured).
        The table costs ~50 s of host math per 1e8 k-mers (u64 CDF map +
        slot packing), so it is memoized in RAM and -- when `cache_dir`
        is set (DB artifact directory) -- persisted as bucket_table.npy +
        bucket_meta.json and mmap-loaded on later runs.  The meta file
        carries a fingerprint of the CURRENT kmers array (length + strided
        sample xor): rebuilding a database in place invalidates the table
        instead of silently serving stale (start, count) rows that index
        the old sorted array.
        Returns (table int32 [2^bits, 16], bits)."""
        if self._bucket is not None:
            return self._bucket
        cache = None
        if self.cache_dir and bits is None:
            cache = os.path.join(self.cache_dir, "bucket_table.npy")
            meta = os.path.join(self.cache_dir, "bucket_meta.json")
            if os.path.exists(cache) and os.path.exists(meta):
                import json
                try:
                    m = json.loads(open(meta).read())
                except (ValueError, OSError):
                    m = {}
                if (m.get("version") == self.BUCKET_TABLE_VERSION and
                        m.get("n") == len(self.kmers) and
                        m.get("fp") == self._fingerprint()):
                    tbl = np.load(cache, mmap_mode="r")
                    self._bucket = (tbl, int(m["bits"]))
                    return self._bucket
        m = len(self.kmers)
        if bits is None:
            lam_bits = max((max(m, 2) - 1).bit_length(), 1)
            # lambda ~ 1.5-2; the floor of 21 bits keeps every bucket's
            # value span within the 12-bit t-delta field (span ~ 2^(33-b)),
            # so small databases pay a 128 MiB table instead of a second
            # row layout
            bits = min(max(lam_bits - 1, 21), 26)
        nb = 1 << bits
        km = self.kmers
        t = (km >> np.uint64(32))
        v = (t << np.uint64(1)) - ((t * t) >> np.uint64(32))
        # v <= 2^32 (monotone; the edge v == 2^32 clamps into the last
        # bucket).  Shifting by 32 - bits addresses the FULL table: the
        # former 33 - bits shift reached only buckets [0, 2^(bits-1)],
        # doubling per-bucket occupancy and wasting half the rows.
        b = np.minimum(v >> np.uint64(32 - bits),
                       np.uint64(nb - 1)).astype(np.int64)
        counts = np.bincount(b, minlength=nb)[:nb]
        start = np.zeros(nb + 1, np.int64)
        np.cumsum(counts, out=start[1:])
        tbl = np.zeros((nb, 16), np.int32)
        tbl[:, 0] = start[:-1].astype(np.int32)
        S, DB = self.BUCKET_SLOTS, self.BUCKET_DELTA_BITS
        t_base = np.zeros(nb, np.uint32)
        nonempty = counts > 0
        t_base[nonempty] = t[start[:-1][nonempty]].astype(np.uint32)
        tbl[:, 2] = t_base.view(np.int32)
        slot = np.arange(m, dtype=np.int64) - start[b]
        ok = slot < S
        rows = b[ok]
        s = slot[ok]
        tbl[rows, 7 + s] = (km[ok] & np.uint64(0xFFFFFFFF)) \
            .astype(np.uint32).view(np.int32)
        delta = (t[ok].astype(np.uint32) - t_base[rows]).astype(np.int64)
        d_over = delta >= (1 << DB)
        # 2 slots per word, no field crosses a word boundary; int16 slot
        # array keeps the transient at 2 bytes/slot
        darr = np.zeros((nb, S), np.int16)
        darr[rows, s] = np.where(d_over, 0, delta).astype(np.int16)
        packed = darr[:, 0::2].astype(np.int32) | \
            (darr[:, 1::2].astype(np.int32) << DB)
        tbl[:, 3:3 + S // 2] = packed
        escape = counts > S
        if d_over.any():
            escape = escape.copy()
            escape[np.unique(rows[d_over])] = True
        cnt = counts.astype(np.int64) | (escape.astype(np.int64) << 30)
        tbl[:, 1] = cnt.astype(np.int32)
        if cache is not None:
            try:
                import json
                np.save(cache, tbl)
                with open(os.path.join(self.cache_dir,
                                       "bucket_meta.json"), "w") as fh:
                    fh.write(json.dumps({
                        "version": self.BUCKET_TABLE_VERSION,
                        "bits": bits, "n": len(self.kmers),
                        "fp": self._fingerprint()}))
            except OSError:
                pass       # read-only DB dir: rebuild next time
        self._bucket = (tbl, bits)
        return self._bucket

    def _fingerprint(self) -> int:
        """Cheap content fingerprint of the sorted k-mer column: xor of
        <= 4096 strided samples (+ ends).  Detects in-place DB rebuilds
        without reading the whole (possibly memmapped) array."""
        m = len(self.kmers)
        if m == 0:
            return 0
        samp = np.asarray(self.kmers[::max(m // 4096, 1)])
        acc = np.bitwise_xor.reduce(samp) ^ np.uint64(self.kmers[m - 1])
        return int(acc ^ np.uint64(m))

    # --- persistence ---

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez(os.path.join(directory, "kmer_index.npz"),
                 kmers=self.kmers, entry_id=self.entry_id,
                 offset=self.offset, rc=self.rc)

    @classmethod
    def load(cls, directory: str) -> "KmerIndex":
        npz = os.path.join(directory, "kmer_index.npz")
        if os.path.exists(npz):
            data = np.load(npz)
            out = cls(data["kmers"], data["entry_id"], data["offset"],
                      data["rc"].astype(bool))
            out.cache_dir = directory
            return out
        return cls.load_npy(directory, mmap=True)  # build_streamed layout

    # --- sharding ---

    def shard_bounds(self, num_shards: int) -> np.ndarray:
        """Split points (by array position) giving near-equal shards that
        never split a run of equal k-mers (a pileup lives on one shard)."""
        bounds = [0]
        m = len(self.kmers)
        for s in range(1, num_shards):
            pos = (m * s) // num_shards
            # advance past the current equal-k-mer run
            while pos < m and pos > 0 and self.kmers[pos] == self.kmers[pos - 1]:
                pos += 1
            bounds.append(pos)
        bounds.append(m)
        return np.array(bounds, dtype=np.int64)

    def shard(self, bounds: np.ndarray, s: int) -> "KmerIndex":
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        return KmerIndex(self.kmers[lo:hi], self.entry_id[lo:hi],
                         self.offset[lo:hi], self.rc[lo:hi])
