"""Host-genome 16-mer membership table (the reference's LookupTable.h +
KMerLookupTable.h build path, writeLookupTable KMerLookupTable.h:302-310).

Two exact storage layouts, selected by density:
  * "sorted": unique canonical 16-mers as a sorted uint32 array; device
    membership = binary search (ops/screen.table_lookup_sorted).  4 bytes
    per distinct k-mer -- smaller for bacterial-scale hosts.
  * "bitset": the reference's 2^32-bit table as 2^27 uint32 words; device
    membership = word gather + bit test.  Fixed 512MB -- smaller for
    mammalian-scale hosts (>1G distinct k-mers).

Both are built from genome entries with k-mer stride gap = K/2 = 8
(KMerLookupTable.h:307) and canonical min(fwd, rc) 16-mers.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops import encode

K16 = 16
_BITSET_WORDS = 1 << 27


def _canonical_16mers(ascii_bytes: np.ndarray, gap: int) -> np.ndarray:
    codes = encode.kmer_codes_np(ascii_bytes).astype(np.uint32)
    l = len(codes)
    if l < K16:
        return np.zeros(0, np.uint32)
    starts = np.arange(0, l - K16 + 1, gap, dtype=np.int64)
    fwd = np.zeros(len(starts), np.uint32)
    rev = np.zeros(len(starts), np.uint32)
    rc = codes ^ np.uint32(2)
    for t in range(K16):
        fwd = (fwd << np.uint32(2)) | codes[starts + t]
        rev = rev | (rc[starts + t] << np.uint32(2 * t))
    return np.minimum(fwd, rev)


class HostTable:
    def __init__(self, kind: str, data: np.ndarray):
        assert kind in ("sorted", "bitset")
        self.kind = kind
        self.data = data

    @classmethod
    def build(cls, gindex, gap: int = K16 // 2,
              kind: str = "auto") -> "HostTable":
        """Build from a GenbankIndex of host entries."""
        parts = [
            _canonical_16mers(
                np.frombuffer(e.bases.encode(), dtype=np.uint8), gap)
            for e in gindex.entries]
        kmers = (np.unique(np.concatenate(parts)) if parts
                 else np.zeros(0, np.uint32))
        if kind == "auto":
            kind = "bitset" if kmers.nbytes > _BITSET_WORDS * 4 else "sorted"
        if kind == "sorted":
            return cls("sorted", kmers)
        words = np.zeros(_BITSET_WORDS, np.uint32)
        np.bitwise_or.at(words, (kmers >> np.uint32(5)).astype(np.int64),
                         np.uint32(1) << (kmers & np.uint32(31)))
        return cls("bitset", words)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        np.savez(os.path.join(directory, "host_table.npz"),
                 kind=self.kind, data=self.data)

    @classmethod
    def load(cls, directory: str) -> "HostTable":
        z = np.load(os.path.join(directory, "host_table.npz"))
        return cls(str(z["kind"]), z["data"])
