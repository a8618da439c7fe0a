"""Host-read and low-complexity screening on the run's device.

Counterpart of kslam_tpu/ops/screen.py (the reference's KMerLookupTable
subsystem, KMerLookupTable.h): a k=16 membership structure over host
genome k-mers, per-position lookups along each read, greedy strided
chains and the two-chain host decision rule, all as tensor ops.

The contract is the reference package's, exactly:
  * every read position is looked up with the canonical min(fwd, rc)
    16-mer (KMerLookupTable.h:98-111),
  * chains are greedy strided runs, runs shorter than 3 dropped
    (KMerLookupTable.h:116-143); ties of length prefer the smaller start,
  * isHost: longest chain >= cutoff, else the two longest chains do not
    overlap (end = start + len*8 + 7, the reference's hardcoded 8) and
    their combined length reaches the secondary cutoff
    (KMerLookupTable.h:149-161,204-215),
  * low-complexity reads (distinct forward 3-mers below cutoff,
    KMer.h:286-301) and reads shorter than 16 are never host,
  * per-read cutoffs floor(.09*len+1.1), floor(.082*len+3.04) and
    floor(.1*len+26) in float32, one rounding per operation as in the
    reference package (KMerLookupTable.h:257-270).

torch has few uint32 operations and no uint32 searchsorted, so 16-mers
(< 2^32) ride int64, and the sorted table is int64.  The bitset table's
uint32 words are stored as int32: an arithmetic right shift by b < 32
still brings bit b to bit 0, so `(word >> b) & 1` is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import metrics
from . import encode

K16 = 16
_BLOCK = 1 << 16      # reads screened per block (bounds the [N, W] temps)


def kmer16_canonical(codes, lengths):
    """Canonical (min of fwd/rc) 16-mers at every position.

    Args: codes [N, L] 2-bit base codes; lengths [N].
    Returns (kmer int64 [N, W] in [0, 2^32), valid bool [N, W]),
    W = L-15."""
    c = codes.to(torch.int64)
    n, l = c.shape
    w = l - K16 + 1
    fwd = torch.zeros((n, w), dtype=torch.int64, device=c.device)
    rev = torch.zeros((n, w), dtype=torch.int64, device=c.device)
    rc = c ^ 2
    for t in range(K16):
        fwd = (fwd << 2) | c[:, t:t + w]
        rev = rev | (rc[:, t:t + w] << (2 * t))
    start = torch.arange(w, dtype=torch.int32, device=c.device)[None, :]
    valid = (start + K16) <= lengths[:, None]
    return torch.minimum(fwd, rev), valid


def distinct_3mer_count(codes, lengths):
    """Distinct forward 3-mers per read (KMer.h:286-301): a 64-slot
    presence mask per read, filled by one scatter (positions past the
    read end go to a spare slot 64)."""
    c = codes.to(torch.int64)
    n, l = c.shape
    ids = (c[:, :-2] << 4) | (c[:, 1:-1] << 2) | c[:, 2:]
    pos = torch.arange(l - 2, dtype=torch.int64, device=c.device)[None, :]
    ok = (pos + 3) <= lengths[:, None]
    present = torch.zeros((n, 65), dtype=torch.bool, device=c.device)
    present.scatter_(1, torch.where(ok, ids, 64), True)
    return present[:, :64].sum(dim=1).to(torch.int32)


def table_lookup_sorted(kmers, table_sorted):
    """Membership via binary search in a sorted unique int64 array."""
    flat = kmers.reshape(-1)
    m = table_sorted.shape[0]
    if m == 0:
        return torch.zeros(kmers.shape, dtype=torch.bool, device=kmers.device)
    i = torch.clamp(torch.searchsorted(table_sorted, flat), 0, m - 1)
    return (table_sorted[i] == flat).reshape(kmers.shape)


def table_lookup_bitset(kmers, words):
    """Membership via the 2^32-bit table stored as int32 words [2^27]
    (the uint32 words' bits)."""
    flat = kmers.reshape(-1)
    word = words[flat >> 5]
    bit = (word >> (flat & 31).to(torch.int32)) & 1
    return (bit == 1).reshape(kmers.shape)


def chain_top2(found, gap: int):
    """Greedy strided chains; returns the two longest (len, start) per
    read.  found: bool [N, W].  Chains shorter than 3 are dropped (len 0
    output)."""
    n, w = found.shape
    run = found.to(torch.int32)
    # run length at each position along stride `gap`:
    #   len[i] = found[i] ? 1 + len[i+gap] : 0, log-depth doubling;
    # invariant: run[i] = min(true_len[i], t) before each step
    t = 1
    while t * gap < w:
        shifted = torch.zeros_like(run)
        shifted[:, :w - t * gap] = run[:, t * gap:]
        run = run + torch.where(run == t, shifted, 0)
        t *= 2
    # chain heads: found[i] and not consumed by a found at i-gap
    prev = torch.zeros_like(found)
    prev[:, gap:] = found[:, :-gap]
    head = found & ~prev
    length = torch.where(head & (run >= 3), run, 0)
    # top-2 by (length desc, start asc): key = len*2^16 + (2^16-1-start)
    start = torch.arange(w, dtype=torch.int32, device=found.device)[None, :]
    key = torch.where(length > 0, (length << 16) + (65535 - start), 0)
    k1 = key.max(dim=1).values
    k2 = torch.where(key == k1[:, None], 0, key).max(dim=1).values

    def unpack(k):
        ln = k >> 16
        return ln, torch.where(ln > 0, 65535 - (k & 65535), 0)
    l1, s1 = unpack(k1)
    l2, s2 = unpack(k2)
    return l1, s1, l2, s2


def _cutoff(flen, slope: float, intercept: float):
    """floor(slope * len + intercept) in float32, one rounding per op."""
    return torch.floor(flen * slope + intercept).to(torch.int32)


def screen_reads(bases, lengths, table, gap: int = 8,
                 lookup_kind: str = "sorted"):
    """Batched labelHostReads + labelLowComplexityReads decisions.

    Args:
      bases: uint8 ASCII [N, L]; lengths int32 [N].
      table: sorted int64 [M] (lookup_kind="sorted") or int32 words
        [2^27] (lookup_kind="bitset"), on the device of `bases`.
    Returns (is_host bool [N], num_distinct_3mers int32 [N])."""
    codes = encode.kmer_codes(bases)
    n3 = distinct_3mer_count(codes, lengths)
    flen = lengths.to(torch.float32)
    cutoff = _cutoff(flen, 0.09, 1.1)
    secondary = _cutoff(flen, 0.082, 3.04)
    complexity = _cutoff(flen, 0.1, 26.0)

    k16, valid = kmer16_canonical(codes, lengths)
    if lookup_kind == "bitset":
        found = table_lookup_bitset(k16, table) & valid
    else:
        found = table_lookup_sorted(k16, table) & valid

    l1, s1, l2, s2 = chain_top2(found, gap)
    e1 = s1 + l1 * 8 + 7          # reference hardcodes 8 (not gap)
    e2 = s2 + l2 * 8 + 7
    primary = (l1 > 0) & (l1 >= cutoff)
    no_overlap = ~((s1 <= e2) & (s2 <= e1))
    two_chain = (l2 > 0) & ((l1 + l2) >= secondary) & no_overlap
    low_complexity = n3 < complexity
    too_short = lengths < K16
    is_host = ~low_complexity & ~too_short & (primary | two_chain)
    return is_host, n3


def table_tensor(table, device) -> torch.Tensor:
    """A db/host_table.HostTable's data as the lookup's tensor."""
    data = np.asarray(table.data, np.uint32)
    if table.kind == "bitset":
        return torch.as_tensor(data.view(np.int32)).to(device)
    return torch.as_tensor(data.astype(np.int64)).to(device)


def label_host_reads(batch, table, lookup_kind: str = "sorted"):
    """is_host mask (numpy bool [N]) of a ReadBatch against a table
    tensor (table_tensor), on the table's device, in blocks of reads (the
    caller removes flagged reads, KMerLookupTable.h:262-270)."""
    dev = table.device
    out = []
    for lo in range(0, batch.num_reads, _BLOCK):
        is_host, _ = screen_reads(
            torch.as_tensor(batch.bases[lo:lo + _BLOCK]).to(dev),
            torch.as_tensor(batch.lengths[lo:lo + _BLOCK]).to(dev),
            table, gap=8, lookup_kind=lookup_kind)
        out.append(is_host.cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, bool)


def label_low_complexity_reads(batch, cutoff: int, device):
    """Low-complexity flags (numpy bool [N]) at a fixed cutoff
    (KMerLookupTable.h:280-298; flags only, no removal -- the
    reference's removal is commented out)."""
    out = []
    with metrics.stage("low_complexity"):
        for lo in range(0, batch.num_reads, _BLOCK):
            codes = encode.kmer_codes(
                torch.as_tensor(batch.bases[lo:lo + _BLOCK]).to(device))
            n3 = distinct_3mer_count(
                codes,
                torch.as_tensor(batch.lengths[lo:lo + _BLOCK]).to(device))
            out.append((n3 < cutoff).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0, bool)
