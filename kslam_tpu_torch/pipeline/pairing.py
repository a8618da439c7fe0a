"""Pairing, insert-size model, screens, pseudo-assembly (host stage).

Mirrors PairedOverlap.h exactly.  These stages are inherently sequential
sweeps over per-read groups (tiny data after SW screening), so they run on
the host; the Python implementation is the functional specification and the
C++ runtime (csrc/) accelerates the identical semantics for production.

Known deviation: the reference uses unstable std::sort for the per-read
score/insert-size orderings (PairedOverlap.h:371,403), so the relative order
of *ties* is unspecified there; we use stable sorts (deterministic).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class AlignedOverlap:
    """One SW-validated overlap (Overlap.h:53-74 flattened)."""
    read_id: int
    entry_id: int
    rel_pos: int
    rc: bool
    score: int
    ref_begin: int
    ref_end: int
    query_begin: int
    query_end: int
    cigar: Optional[list] = None  # [(len, op)] when reportCigar


@dataclasses.dataclass
class PairedOverlap:
    """PairedOverlap.h:32-58; r1/r2 reference AlignedOverlap or None."""
    combined_score: int
    entry_id: int
    ref_start: int
    ref_end: int
    insert_size: int          # uint32 semantics (can hold wrapped negatives)
    r1: Optional[AlignedOverlap]
    r2: Optional[AlignedOverlap]

    @property
    def has_r1(self) -> bool:
        return self.r1 is not None

    @property
    def has_r2(self) -> bool:
        return self.r2 is not None


@dataclasses.dataclass
class ReadPairAlignments:
    """ReadPairAndOverlaps (PairedOverlap.h:62-75)."""
    r1_pos: int
    r2_pos: int
    pairs: List[PairedOverlap]


U32 = 1 << 32


def _u32(x: int) -> int:
    return x & (U32 - 1)


def _make_pair(r1: AlignedOverlap, r2: AlignedOverlap, orientation: bool,
               read_lengths) -> PairedOverlap:
    """PairedOverlap.h:107-123; insert size in uint32 arithmetic."""
    ref_start = min(r1.ref_begin, r2.ref_begin)
    ref_end = max(r1.ref_end, r2.ref_end)
    if orientation:  # R1....R2
        insert = _u32(r2.rel_pos - r1.rel_pos + int(read_lengths[r2.read_id]))
    else:
        insert = _u32(r1.rel_pos - r2.rel_pos + int(read_lengths[r1.read_id]))
    return PairedOverlap(r1.score + r2.score, r2.entry_id, ref_start,
                         ref_end, insert, r1, r2)


def _half_pair(o: AlignedOverlap, is_r1: bool) -> PairedOverlap:
    return PairedOverlap(o.score, o.entry_id, o.ref_begin, o.ref_end, 0,
                         o if is_r1 else None, None if is_r1 else o)


def get_paired_overlaps(overlaps: List[AlignedOverlap], read_lengths,
                        midpoint: int) -> List[PairedOverlap]:
    """The pairing sweep (PairedOverlap.h:132-271): sort by
    (read%midpoint, entry, relPos) then pair adjacent opposite-orientation
    R1/R2 hits per (read-pair, entry) run; unpaired become half-pairs."""
    overlaps = sorted(overlaps, key=lambda o: (o.read_id % midpoint,
                                               o.entry_id, o.rel_pos))
    out: List[PairedOverlap] = []
    i = 0
    n = len(overlaps)
    while i < n:
        # one (read-pair, entry) run
        rid = overlaps[i].read_id % midpoint
        ent = overlaps[i].entry_id
        last_r1 = last_r2 = last_r1_rc = last_r2_rc = None
        used_r1 = used_r2 = used_r1_rc = used_r2_rc = False
        while i < n and overlaps[i].read_id % midpoint == rid and \
                overlaps[i].entry_id == ent:
            cur = overlaps[i]
            if cur.read_id < midpoint:  # R1
                if cur.rc:
                    if not used_r1_rc and last_r1_rc is not None:
                        out.append(_half_pair(last_r1_rc, True))
                    last_r1_rc, used_r1_rc = cur, False
                    if last_r2 is not None:
                        out.append(_make_pair(cur, last_r2, False,
                                              read_lengths))
                        used_r1_rc = used_r2 = True
                else:
                    if not used_r1 and last_r1 is not None:
                        out.append(_half_pair(last_r1, True))
                    last_r1, used_r1 = cur, False
                    if last_r2_rc is not None:
                        out.append(_make_pair(cur, last_r2_rc, False,
                                              read_lengths))
                        used_r1 = used_r2_rc = True
            else:  # R2
                if cur.rc:
                    if not used_r2_rc and last_r2_rc is not None:
                        out.append(_half_pair(last_r2_rc, False))
                    last_r2_rc, used_r2_rc = cur, False
                    if last_r1 is not None:
                        out.append(_make_pair(last_r1, cur, True,
                                              read_lengths))
                        used_r1 = used_r2_rc = True
                else:
                    if not used_r2 and last_r2 is not None:
                        out.append(_half_pair(last_r2, False))
                    last_r2, used_r2 = cur, False
                    if last_r1_rc is not None:
                        out.append(_make_pair(last_r1_rc, cur, True,
                                              read_lengths))
                        used_r1_rc = used_r2 = True
            i += 1
        # trailing flush, reference order: R2, R2rc, R1, R1rc
        # (PairedOverlap.h:217-240)
        if not used_r2 and last_r2 is not None:
            out.append(_half_pair(last_r2, False))
        if not used_r2_rc and last_r2_rc is not None:
            out.append(_half_pair(last_r2_rc, False))
        if not used_r1 and last_r1 is not None:
            out.append(_half_pair(last_r1, True))
        if not used_r1_rc and last_r1_rc is not None:
            out.append(_half_pair(last_r1_rc, True))
    return out


def group_pairs_per_read(pairs: List[PairedOverlap],
                         midpoint: int) -> List[ReadPairAlignments]:
    """getPerReadOverlaps (PairedOverlap.h:437-470)."""
    groups: List[ReadPairAlignments] = []
    current: List[PairedOverlap] = []
    read_pos = 0
    for pair in pairs:
        this_pos = (pair.r1.read_id if pair.has_r1
                    else pair.r2.read_id - midpoint)
        if this_pos != read_pos and current:
            groups.append(ReadPairAlignments(read_pos, read_pos + midpoint,
                                             current))
            current = []
        read_pos = this_pos
        current.append(pair)
    if current:
        groups.append(ReadPairAlignments(read_pos, read_pos + midpoint,
                                         current))
    return groups


def dummy_pairs_from_single_end(
        overlaps: List[AlignedOverlap]) -> List[ReadPairAlignments]:
    """getDummyAlignmentPairsFromSingleEndReads (PairedOverlap.h:280-298):
    every overlap becomes an R1-only half pair; r2_pos is 0."""
    groups: List[ReadPairAlignments] = []
    current: List[PairedOverlap] = []
    read_pos = None
    for o in overlaps:
        if o.read_id != read_pos and current:
            groups.append(ReadPairAlignments(read_pos, 0, current))
            current = []
        read_pos = o.read_id
        current.append(_half_pair(o, True))
    if current:
        groups.append(ReadPairAlignments(read_pos, 0, current))
    return groups


def max_allowed_insert_size(reads_and_pairs: List[ReadPairAlignments]) -> int:
    """PairedOverlap.h:300-360 over a host pair list."""
    sizes: List[int] = []
    for read in reads_and_pairs:
        for pair in read.pairs:
            if pair.insert_size != 0:
                v = pair.insert_size
                sizes.append(v - U32 if v >= U32 // 2 else v)
    return max_allowed_insert_size_from_sizes(sizes)


def max_allowed_insert_size_from_sizes(sizes) -> int:
    """PairedOverlap.h:300-360: percentile spike detection, IQR fallback,
    then mean + 6 sigma of the truncated distribution.  `sizes` are the
    nonzero insert sizes already reinterpreted as int32 (the reference
    collects uint32 fields into an int32 vector): an int64 array, or a
    list of ints."""
    sizes = np.sort(np.asarray(sizes, dtype=np.int64))
    n = len(sizes)
    if n == 0:
        return U32 - 1
    limit = 0
    idx = np.floor(n * np.arange(100) / 100.0).astype(np.int64)
    vals = sizes[idx]
    spikes = np.flatnonzero(vals[1:] - vals[:-1] > 1000)
    if len(spikes):
        limit = int(vals[spikes[0]])
    lq = int(sizes[math.floor(n * 0.25)])
    uq = int(sizes[math.floor(n * 0.75)])
    lower = 0
    upper = uq + 2 * (uq - lq)
    if limit:
        upper = limit
    if upper == 0:
        upper = 2**31 - 1
    kept = sizes[(sizes >= lower) & (sizes <= upper)]
    if len(kept) == 0:
        return U32 - 1  # 0/0 -> nan -> UINT_MAX (PairedOverlap.h:359)
    # exact integer sums in int64 with no Python int per size: kept is
    # >= 0 and < 2^32, squared by 16-bit halves (v^2 = hi^2 2^32 +
    # 2 hi lo 2^16 + lo^2, each term < 2^32), so no sum of a block of
    # 2^30 wraps
    ksum = ksq = 0
    for i in range(0, len(kept), 1 << 30):
        part = kept[i:i + (1 << 30)]
        hi, lo = part >> 16, part & 0xFFFF
        ksum += int(part.sum())
        ksq += (int((hi * hi).sum()) << 32) + \
            (int((hi * lo).sum()) << 17) + int((lo * lo).sum())
    mean = ksum / len(kept)
    sq = ksq / len(kept)
    var = sq - mean * mean
    # sqrt of a (numerically) negative variance is nan in the reference
    std = math.sqrt(var) if var >= 0 else float("nan")
    result = mean + 6 * std
    if math.isnan(result):
        return U32 - 1
    return min(int(math.floor(result)), U32 - 1)


def screen_pairs_by_score(reads_and_pairs: List[ReadPairAlignments],
                          fraction: float) -> None:
    """PairedOverlap.h:361-390: per read, keep pairs with combinedScore >=
    fraction * top (prefix of the score-descending order)."""
    for read in reads_and_pairs:
        if not read.pairs:
            continue
        read.pairs.sort(key=lambda p: -p.combined_score)
        top = read.pairs[0].combined_score
        cut = len(read.pairs)
        for i, pair in enumerate(read.pairs):
            if pair.combined_score < top * fraction:
                cut = i
                break
        del read.pairs[cut:]


def screen_pairs_by_insert_size(reads_and_pairs: List[ReadPairAlignments],
                                max_insert: int, replace: bool) -> None:
    """PairedOverlap.h:396-436: drop pairs with insertSize > max (uint32
    compare); with replace=True the dropped pairs split into two
    half-pairs (R1 appended, the original mutates into R2-only)."""
    for read in reads_and_pairs:
        read.pairs.sort(key=lambda p: p.insert_size)
        cut = len(read.pairs)
        for i, pair in enumerate(read.pairs):
            if pair.insert_size > max_insert:
                cut = i
                break
        if replace:
            tail = read.pairs[cut:]
            for pair in tail:
                read.pairs.append(_half_pair(pair.r1, True))
                pair.combined_score = pair.r2.score
                pair.ref_start = pair.r2.ref_begin
                pair.ref_end = pair.r2.ref_end
                pair.insert_size = 0
                pair.r1 = None
        else:
            del read.pairs[cut:]


def pseudo_assembly(reads_and_pairs: List[ReadPairAlignments]) -> None:
    """PairedOverlap.h:471-576: per genome entry, chain alignment pairs that
    overlap the running chain along the reference by >= 20 bases and rescore
    every member: coverage * avgScorePerBase * length (double math,
    truncated into the uint32 combinedScore)."""
    by_entry = {}
    for read in reads_and_pairs:
        for pair in read.pairs:
            by_entry.setdefault(pair.entry_id, []).append(pair)
    for pairs in by_entry.values():
        pairs.sort(key=lambda p: p.ref_start)

        def rescore(chain, highest, num_bases, per_base, count):
            length = float(highest - chain[0].ref_start)
            if length != 0.0:
                cov = num_bases / length
            else:  # C++ double division: 0/0 -> nan, x/0 -> inf
                cov = float("nan") if num_bases == 0 else float("inf")
            avg = per_base / count
            score = cov * avg * length
            # double -> uint32 of a non-finite value: x86 cvttsd2si yields 0
            # after truncation; mirror that
            for member in chain:
                member.combined_score = (_u32(int(score))
                                         if math.isfinite(score) else 0)

        chain: List[PairedOverlap] = []
        highest = -1000000
        num_bases = 0
        per_base = 0.0
        for pair in pairs:
            if pair.ref_start > highest - 20:
                if len(chain) > 1:
                    rescore(chain, highest, num_bases, per_base, len(chain))
                chain = [pair]
                highest = pair.ref_end
                span = abs(pair.ref_end - pair.ref_start)
                per_base = pair.combined_score / span if span else \
                    float("inf")
                num_bases = span
            else:
                if pair.ref_end > highest:
                    highest = pair.ref_end
                span = abs(pair.ref_end - pair.ref_start)
                per_base += pair.combined_score / span if span else \
                    float("inf")
                num_bases += span
                chain.append(pair)
        if len(chain) > 1:
            rescore(chain, highest, num_bases, per_base, len(chain))
