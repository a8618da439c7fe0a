"""Golden scalar model of the candidate-overlap stage (seeding).

Emulates the reference's alignToDatabase front half exactly, at small scale,
for differential testing of the device match engine:
  k-merize reads (gap 1) + genomes (gap 16), sort the union, scan pileups
  (genome k-mers first), emit (read, entry, relative_position, rc), sort by
  (read, entry, relPos) and chain-dedup overlaps with |delta relPos| < 3
  (SLAM.h:59-79, Overlap.h:153-295).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..config import K, GENOME_KMER_GAP
from ..ops import kmers as kmer_ops


def read_kmers_scalar(bases: str):
    """(kmer, offset, rc) per position, reference read semantics."""
    ascii_bytes = np.frombuffer(bases.encode(), dtype=np.uint8)
    km, start, rc = kmer_ops.sequence_kmers_np(ascii_bytes, 1)
    length = len(bases)
    offset = np.where(rc, length - start - K, start)
    return km, offset.astype(np.int64), rc


def find_overlaps_golden(reads: List[str], genomes: List[str],
                         gap: int = GENOME_KMER_GAP
                         ) -> List[Tuple[int, int, int, bool]]:
    """Returns deduped [(read_id, entry_id, rel_pos, rc)] in the
    reference's post-sort order."""
    records = []  # (kmer, is_gb, rc, id, offset)
    for rid, bases in enumerate(reads):
        km, off, rc = read_kmers_scalar(bases)
        for k_, o_, r_ in zip(km, off, rc):
            records.append((int(k_), 0, bool(r_), rid, int(o_)))
    for gid, bases in enumerate(genomes):
        ascii_bytes = np.frombuffer(bases.encode(), dtype=np.uint8)
        km, start, rc = kmer_ops.sequence_kmers_np(ascii_bytes, gap)
        for k_, o_, r_ in zip(km, start, rc):
            records.append((int(k_), 1, bool(r_), gid, int(o_)))
    # sortKMers (KMer.h:388-398): by kmer, ties ID_isFromGB_RC descending so
    # genome k-mers precede read k-mers in each pileup
    def id_field(rec):
        _, is_gb, rc, id_, _ = rec
        return (id_ & 0x3FFFFFFF) | (rc << 30) | (is_gb << 31)
    records.sort(key=lambda r: (r[0], -id_field(r)))

    overlaps = []
    i = 0
    n = len(records)
    read_lens = [len(b) for b in reads]
    while i < n:
        j = i
        while j < n and records[j][0] == records[i][0]:
            j += 1
        pileup = records[i:j]
        if records[i][0] != 0 and len(pileup) > 1 and pileup[0][1] == 1:
            # processPileUp (Overlap.h:153-199): genome k-mers first, then
            # for each read k-mer emit one overlap per preceding genome k-mer
            gb = [p for p in pileup if p[1] == 1]
            for p in pileup:
                if p[1] == 1:
                    continue
                _, _, read_rc, rid, read_off = p
                for g in gb:
                    _, _, gb_rc, gid, gb_off = g
                    same_comp = gb_rc == read_rc
                    offset = (read_lens[rid] - read_off - K) if gb_rc else read_off
                    overlaps.append((rid, gid, gb_off - offset, not same_comp))
        i = j
    # findOverlaps_parallel tail (Overlap.h:289-291): sort + chained unique
    overlaps.sort(key=lambda o: (o[0], o[1], o[2]))
    return chained_dedup(overlaps)


def chained_dedup(sorted_overlaps: List[Tuple[int, int, int, bool]]):
    """std::unique semantics with overlapEqual (Overlap.h:79-85): compare
    each candidate against the last KEPT overlap."""
    kept: List[Tuple[int, int, int, bool]] = []
    for o in sorted_overlaps:
        if kept and kept[-1][0] == o[0] and kept[-1][1] == o[1] and \
                abs(kept[-1][2] - o[2]) < 3:
            continue
        kept.append(o)
    return kept
