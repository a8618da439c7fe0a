"""The k-mer index of a generated database, built on the device.

Canonical k-mers (k = 32) every `gap` bases of each entry, in the order
of the port's KmerIndex.build: k-mer word ascending, ties by
(rc, entry, offset) descending (rc:1 | entry:31 | offset:31 in one
word).  kslam_tpu_torch/db/kmer_index.py sorts on the host with
np.lexsort; here two stable device sorts give the same order.

Codes: A=0 C=1 T=2 G=3, anything else A (KMer.h:246-266); a k-mer's
first base is in its high bits; the canonical word is min(fwd, rc),
and a palindrome takes the rc branch.  Words are int64 with the bits of
the unsigned word; unsigned order is compared as keys (word ^ 2^63).
"""

from __future__ import annotations

import numpy as np
import torch

K = 32
FLIP = -(1 << 63)


def kmer_codes(ascii_u8: torch.Tensor) -> torch.Tensor:
    lut = torch.zeros(256, dtype=torch.uint8, device=ascii_u8.device)
    for c, v in zip(b"ACTG", range(4)):
        lut[c] = v
    return lut[ascii_u8.to(torch.int64)]


def canonical(codes: torch.Tensor, starts: torch.Tensor):
    """(word int64, rc bool) of the k-mers of `codes` at `starts`."""
    fwd = torch.zeros(starts.shape, dtype=torch.int64, device=codes.device)
    rev = torch.zeros_like(fwd)
    for t in range(K):
        c = codes[starts + t].to(torch.int64)
        fwd = (fwd << 2) | c
        rev = rev | ((c ^ 2) << (2 * t))
    rc = (fwd ^ FLIP) >= (rev ^ FLIP)
    return torch.where(rc, rev, fwd), rc


def starts_of(offsets: np.ndarray, gap: int):
    """(entry int32 [M], offset int32 [M], global start int64 [M]) of
    every indexed k-mer, host arrays."""
    lens = np.diff(offsets)
    per = np.where(lens >= K, (lens - K) // gap + 1, 0)
    entry = np.repeat(np.arange(len(lens), dtype=np.int32), per)
    first = np.concatenate([[0], np.cumsum(per)[:-1]])
    local = (np.arange(int(per.sum()), dtype=np.int64) -
             np.repeat(first, per)) * gap
    return entry, local.astype(np.int32), np.repeat(offsets[:-1], per) + local


def build(bases: torch.Tensor, offsets: np.ndarray, gap: int = 16,
          block: int = 1 << 24):
    """(kmers u64, entry_id i32, offset i32, rc bool) host arrays, sorted
    as KmerIndex.build sorts them."""
    dev = bases.device
    entry, off, gstart = starts_of(offsets, gap)
    m = len(entry)
    codes = kmer_codes(bases)
    key = torch.empty(m, dtype=torch.int64, device=dev)
    rc = torch.empty(m, dtype=torch.bool, device=dev)
    for a in range(0, m, block):
        b = min(a + block, m)
        w, r = canonical(codes, torch.as_tensor(gstart[a:b]).to(dev))
        key[a:b] = w ^ FLIP
        rc[a:b] = r
    del codes
    d_entry = torch.as_tensor(entry).to(dev)
    d_off = torch.as_tensor(off).to(dev)
    tie = (rc.to(torch.int64) << 62) | (d_entry.to(torch.int64) << 31) | \
        d_off.to(torch.int64)
    perm = torch.sort(~tie, stable=True).indices
    del tie
    perm = perm[torch.sort(key[perm], stable=True).indices]
    words = (key[perm] ^ FLIP).cpu().numpy().view(np.uint64)
    return (words, d_entry[perm].cpu().numpy(), d_off[perm].cpu().numpy(),
            rc[perm].cpu().numpy())
