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

Host part only (build, save, load, range shards): the device copy of the
columns is pipeline/align.DeviceDB.from_index, or, on a mesh,
parallel/dist.place_sharded_db.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import GENOME_KMER_GAP
from ..ops import kmers as kmer_ops
from .genbank import GenbankIndex


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
