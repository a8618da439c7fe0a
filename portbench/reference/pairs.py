"""Pairing, the insert-size model, the pair screens and the
pseudo-assembly, as sequential sweeps over per-read lists.

Frozen copy of kslam_tpu_torch's host stage pipeline/pairing.py
(get_paired_overlaps, group_pairs_per_read, max_allowed_insert_size,
screen_pairs_by_insert_size, screen_pairs_by_score, pseudo_assembly),
the line-by-line transcription of k-SLAM's PairedOverlap.h:107-576,
independent of the device code the window runs (ops/pairing_dev,
ops/screens_dev).  Each overlap carries its row in the candidate columns.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

U32 = 1 << 32


class Aligned:
    """One SW-validated overlap (Overlap.h:53-74) and its candidate row."""
    __slots__ = ("row", "read_id", "entry_id", "rel_pos", "rc", "score",
                 "ref_begin", "ref_end")

    def __init__(self, row, read_id, entry_id, rel_pos, rc, score,
                 ref_begin, ref_end):
        self.row, self.read_id, self.entry_id = row, read_id, entry_id
        self.rel_pos, self.rc, self.score = rel_pos, rc, score
        self.ref_begin, self.ref_end = ref_begin, ref_end


class Pair:
    """PairedOverlap.h:32-58; r1 / r2 an Aligned or None."""
    __slots__ = ("combined_score", "entry_id", "ref_start", "ref_end",
                 "insert_size", "r1", "r2")

    def __init__(self, combined_score, entry_id, ref_start, ref_end,
                 insert_size, r1: Optional[Aligned], r2: Optional[Aligned]):
        self.combined_score, self.entry_id = combined_score, entry_id
        self.ref_start, self.ref_end = ref_start, ref_end
        self.insert_size, self.r1, self.r2 = insert_size, r1, r2


class ReadPairs:
    """ReadPairAndOverlaps (PairedOverlap.h:62-75)."""
    __slots__ = ("r1_pos", "pairs")

    def __init__(self, r1_pos: int, pairs: List[Pair]):
        self.r1_pos, self.pairs = r1_pos, pairs


def _u32(x: int) -> int:
    return x & (U32 - 1)


def _make_pair(r1: Aligned, r2: Aligned, orientation: bool,
               read_lengths) -> Pair:
    """PairedOverlap.h:107-123; insert size in uint32 arithmetic."""
    if orientation:  # R1....R2
        insert = _u32(r2.rel_pos - r1.rel_pos + read_lengths[r2.read_id])
    else:
        insert = _u32(r1.rel_pos - r2.rel_pos + read_lengths[r1.read_id])
    return Pair(r1.score + r2.score, r2.entry_id,
                min(r1.ref_begin, r2.ref_begin),
                max(r1.ref_end, r2.ref_end), insert, r1, r2)


def _half_pair(o: Aligned, is_r1: bool) -> Pair:
    return Pair(o.score, o.entry_id, o.ref_begin, o.ref_end, 0,
                o if is_r1 else None, None if is_r1 else o)


def get_paired_overlaps(overlaps: List[Aligned], read_lengths,
                        midpoint: int) -> List[Pair]:
    """The pairing sweep (PairedOverlap.h:132-271): sort by
    (read % midpoint, entry, relPos), then pair adjacent
    opposite-orientation R1/R2 hits per (read pair, entry) run; the
    unpaired become half pairs."""
    overlaps = sorted(overlaps, key=lambda o: (o.read_id % midpoint,
                                               o.entry_id, o.rel_pos))
    out: List[Pair] = []
    i, n = 0, len(overlaps)
    while i < n:
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
        # the run's flush, in the reference's order: R2, R2rc, R1, R1rc
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


def group_pairs_per_read(pairs: List[Pair],
                         midpoint: int) -> List[ReadPairs]:
    """getPerReadOverlaps (PairedOverlap.h:437-470)."""
    groups: List[ReadPairs] = []
    current: List[Pair] = []
    read_pos = 0
    for pair in pairs:
        this_pos = (pair.r1.read_id if pair.r1 is not None
                    else pair.r2.read_id - midpoint)
        if this_pos != read_pos and current:
            groups.append(ReadPairs(read_pos, current))
            current = []
        read_pos = this_pos
        current.append(pair)
    if current:
        groups.append(ReadPairs(read_pos, current))
    return groups


def max_allowed_insert_size(reads: List[ReadPairs]) -> int:
    """PairedOverlap.h:300-360: the nonzero insert sizes as int32,
    percentile spike detection, the IQR fallback, then mean + 6 sigma of
    the truncated distribution, in double."""
    sizes = [p.insert_size - U32 if p.insert_size >= U32 // 2
             else p.insert_size
             for r in reads for p in r.pairs if p.insert_size != 0]
    sizes = np.sort(np.asarray(sizes, dtype=np.int64))
    n = len(sizes)
    if n == 0:
        return U32 - 1
    limit = 0
    vals = sizes[np.floor(n * np.arange(100) / 100.0).astype(np.int64)]
    spikes = np.flatnonzero(vals[1:] - vals[:-1] > 1000)
    if len(spikes):
        limit = int(vals[spikes[0]])
    lq = int(sizes[math.floor(n * 0.25)])
    uq = int(sizes[math.floor(n * 0.75)])
    upper = uq + 2 * (uq - lq)
    if limit:
        upper = limit
    if upper == 0:
        upper = 2**31 - 1
    kept = sizes[(sizes >= 0) & (sizes <= upper)].tolist()
    if not kept:
        return U32 - 1             # 0/0 -> nan -> UINT_MAX (:359)
    mean = sum(kept) / len(kept)
    var = sum(s * s for s in kept) / len(kept) - mean * mean
    std = math.sqrt(var) if var >= 0 else float("nan")
    result = mean + 6 * std
    if math.isnan(result):
        return U32 - 1
    return min(int(math.floor(result)), U32 - 1)


def screen_pairs_by_score(reads: List[ReadPairs], fraction: float) -> None:
    """PairedOverlap.h:361-390: a read keeps the pairs whose
    combinedScore >= fraction * its top score (double product)."""
    for read in reads:
        if not read.pairs:
            continue
        read.pairs.sort(key=lambda p: -p.combined_score)
        top = read.pairs[0].combined_score * fraction
        cut = len(read.pairs)
        for i, pair in enumerate(read.pairs):
            if pair.combined_score < top:
                cut = i
                break
        del read.pairs[cut:]


def screen_pairs_by_insert_size(reads: List[ReadPairs],
                                max_insert: int) -> None:
    """PairedOverlap.h:396-436 with replace=true, the only mode the
    pipeline runs: a pair over the limit becomes its R2 half, and its R1
    half is appended."""
    for read in reads:
        read.pairs.sort(key=lambda p: p.insert_size)
        cut = len(read.pairs)
        for i, pair in enumerate(read.pairs):
            if pair.insert_size > max_insert:
                cut = i
                break
        for pair in read.pairs[cut:]:
            read.pairs.append(_half_pair(pair.r1, True))
            pair.combined_score = pair.r2.score
            pair.ref_start = pair.r2.ref_begin
            pair.ref_end = pair.r2.ref_end
            pair.insert_size = 0
            pair.r1 = None


def pseudo_assembly(reads: List[ReadPairs]) -> None:
    """PairedOverlap.h:471-576: per entry, chain the pairs that overlap
    the running chain by >= 20 bases and rescore every member of a chain
    of two or more: coverage * average score a base * length (double
    math, truncated into the uint32 combinedScore; a non-finite value
    gives 0)."""
    by_entry = {}
    for read in reads:
        for pair in read.pairs:
            by_entry.setdefault(pair.entry_id, []).append(pair)

    def rescore(chain, highest, num_bases, per_base):
        length = float(highest - chain[0].ref_start)
        if length != 0.0:
            cov = num_bases / length
        else:                       # C++ double: 0/0 nan, x/0 inf
            cov = float("nan") if num_bases == 0 else float("inf")
        score = cov * (per_base / len(chain)) * length
        value = _u32(int(score)) if math.isfinite(score) else 0
        for member in chain:
            member.combined_score = value

    for pairs in by_entry.values():
        pairs.sort(key=lambda p: p.ref_start)
        chain: List[Pair] = []
        highest, num_bases, per_base = -1000000, 0, 0.0
        for pair in pairs:
            span = abs(pair.ref_end - pair.ref_start)
            add = pair.combined_score / span if span else float("inf")
            if pair.ref_start > highest - 20:
                if len(chain) > 1:
                    rescore(chain, highest, num_bases, per_base)
                chain = [pair]
                highest, per_base, num_bases = pair.ref_end, add, span
            else:
                highest = max(highest, pair.ref_end)
                per_base += add
                num_bases += span
                chain.append(pair)
        if len(chain) > 1:
            rescore(chain, highest, num_bases, per_base)
