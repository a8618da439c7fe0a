"""Device batch pipeline: alignment through taxonomy without host loops.

Counterpart of kslam_tpu/pipeline/device_path.py.  Two phases split by
the insert-size model (an exact host percentile over the chunk's insert
sizes, PairedOverlap.h:300-360):

  phase A: unpack codes -> canonical k-mers -> join (the DB's table and
           an exact tier 2) + expansion + sort + chained dedup ->
           compact -> chunked SW (the CUDA kernel on the card) ->
           pairing sweep.
  host:    max_allowed_insert_size over the chunk's insert sizes.
  phase B: per batch insert screen (replace) + score screen -> chunk-wide
           concat -> pseudo-assembly chain labels -> exact host double
           rescoring of multi-member chains -> rescreen -> per-read LCA.
  objects: chunk_to_host_pairs builds the host object model of the
           surviving pairs (SAM output and --just-align).

phase_b is one batch's phase B with the float32 device rescoring of the
reference package's dry run; the CLI never runs it.  On a mesh, phase A
is parallel/dist.make_sharded_phase_a, built from decode_reads and
screen_and_pair.

Shapes are dynamic: every stage is sized to the rows that exist (a few
host reads of counts per batch), so nothing is ever dropped to a static
capacity and no emit-all retry is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import encode, kmers, lca as lca_ops, match, pairing_dev, \
    screens_dev, sw
from ..ops.rows import shift1
from ..utils import metrics


class PhaseAOut(NamedTuple):
    overlaps: match.Overlaps          # compacted, SW-validated
    ov_score: torch.Tensor            # int32 [N]
    ov_begin: torch.Tensor
    ov_end: torch.Tensor
    ov_qbegin: torch.Tensor
    ov_qend: torch.Tensor
    pairs: pairing_dev.DevicePairs    # emission-ordered


class PhaseBOut(NamedTuple):
    cols: screens_dev.PairCols        # surviving pairs (group-sorted)
    read_lca: torch.Tensor            # int64 [P] segment-running LCA
    group_last: torch.Tensor          # bool [P] last valid row of group


def _sync(dev: torch.device) -> None:
    """Wait for the device, so a host timer around a stage measures it."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def decode_reads(bases, window_len: int, nbits=None, kbits=None):
    """(k-mer codes, SW codes) of a batch.  bases: ASCII u8 [N, L], or
    with nbits/kbits the packed 2-bit plane [N, ceil(L/4)] of
    encode.pack_reads_np and its bit sidecars."""
    if nbits is None:
        return encode.kmer_codes(bases), encode.sw_codes(bases)
    codes2 = encode.unpack_codes(bases, window_len)
    kcodes = torch.where(encode.unpack_bits(kbits, window_len),
                         torch.zeros_like(codes2), codes2)
    read_scodes = torch.where(encode.unpack_bits(nbits, window_len),
                              torch.full_like(codes2, 4), codes2)
    return kcodes, read_scodes


def screen_and_pair(res: match.Overlaps, al: sw.SWAlignments, lengths,
                    midpoint, score_threshold: int,
                    paired: bool) -> PhaseAOut:
    """The end of phase A on the compacted, SW-validated candidates: the
    score screen, then the pairing sweep (paired) or one R1-only half pair
    per overlap (single-end)."""
    score = torch.where(res.valid, al.score, 0)
    # screenOverlapsByScoreThreshold (Overlap.h:329-341)
    keep = res.valid & (score >= score_threshold)
    res = res._replace(valid=keep, count=keep.sum().to(torch.int32))
    n = res.read_id.shape[0]
    dev = res.read_id.device
    if paired:
        pairs = pairing_dev.pair_overlaps_device(
            res.read_id, res.entry_id, res.rel_pos, res.rc, res.valid,
            score, al.ref_begin, al.ref_end, lengths, midpoint)
    else:
        # single-end: every overlap becomes an R1-only half pair in input
        # order (PairedOverlap.h:280-298)
        rows = torch.arange(n, dtype=torch.int32, device=dev)
        pairs = pairing_dev.DevicePairs(
            r1_idx=torch.where(res.valid, rows, pairing_dev.NONE),
            r2_idx=torch.full((n,), pairing_dev.NONE, dtype=torch.int32,
                              device=dev),
            combined_score=score.to(torch.int64),
            entry_id=res.entry_id, ref_start=al.ref_begin,
            ref_end=al.ref_end,
            insert_size=torch.zeros(n, dtype=torch.int64, device=dev),
            count=res.count)
    return PhaseAOut(res, score, al.ref_begin, al.ref_end, al.query_begin,
                     al.query_end, pairs)


def phase_a(bases, lengths, midpoint, idx_kmers, idx_pack, genome_chunks,
            entry_offsets, match_s: int, mismatch: int, gap_open: int,
            gap_extend: int, window_len: int, score_threshold: int = 0,
            paired: bool = True, nbits=None, kbits=None,
            **join_tables) -> PhaseAOut:
    """One device batch through seeding, SW and pairing.

    bases: ASCII u8 [N, L], or with nbits/kbits the packed 2-bit plane
    [N, ceil(L/4)] of encode.pack_reads_np and its bit sidecars.
    lengths: int32 [N]; midpoint: first R2 row (paired).  join_tables:
    the DB's join tables (align.DeviceDB.join_tables); none joins by
    the exact search."""
    dev = bases.device
    with metrics.stage("phase_a_seed"):
        kcodes, read_scodes = decode_reads(bases, window_len, nbits, kbits)
        km, off, rc, valid = kmers.read_kmers_from_codes(kcodes, lengths)
        res = match.match_overlaps(km, off, rc, valid, lengths, idx_kmers,
                                   idx_pack, **join_tables)
        res = match.compact_overlaps(res)
        _sync(dev)
    with metrics.stage("phase_a_sw"):
        al = sw.align_overlaps_batch_chunked(
            res.read_id, res.entry_id, res.rel_pos, res.rc, res.valid,
            read_scodes, lengths, genome_chunks, entry_offsets,
            match_s, mismatch, gap_open, gap_extend,
            window_len=window_len, n_valid=res.count)
        _sync(dev)
    with metrics.stage("phase_a_pair"):
        out = screen_and_pair(res, al, lengths, midpoint, score_threshold,
                              paired)
        _sync(dev)
    return out


def _group_of(pairs: pairing_dev.DevicePairs, read_id, midpoint):
    """Read-pair position of each emission (r1 read when present, else
    r2 read - midpoint; group_pairs_per_read semantics)."""
    has_r1 = pairs.r1_idx >= 0
    r1 = read_id[torch.clamp(pairs.r1_idx.to(torch.int64), min=0)]
    r2 = read_id[torch.clamp(pairs.r2_idx.to(torch.int64), min=0)]
    return torch.where(has_r1, r1, r2 - int(midpoint))


def phase_b_screens(a: PhaseAOut, midpoint, max_insert, fraction: float,
                    paired: bool = True) -> screens_dev.PairCols:
    """Insert screen + score screen of one batch's emissions (the part of
    phase B before pseudo-assembly).  Emissions are front-compacted by
    the pairing sweep, so only the first `count` rows enter."""
    n = int(a.pairs.count)
    pairs = pairing_dev.DevicePairs(*(c[:n] for c in a.pairs[:-1]),
                                    count=a.pairs.count)
    valid = (pairs.r1_idx >= 0) | (pairs.r2_idx >= 0)
    group = _group_of(pairs, a.overlaps.read_id, midpoint)
    cols = screens_dev.PairCols(
        group=torch.where(valid, group, 0), r1_idx=pairs.r1_idx,
        r2_idx=pairs.r2_idx, combined_score=pairs.combined_score,
        entry_id=pairs.entry_id, ref_start=pairs.ref_start,
        ref_end=pairs.ref_end, insert_size=pairs.insert_size, valid=valid)
    if paired:
        cols = screens_dev.screen_by_insert_device(
            cols, max_insert, a.ov_score, a.ov_begin, a.ov_end)
    return screens_dev.screen_by_score_device(cols, fraction)


def globalize_batch(cols: screens_dev.PairCols, a: PhaseAOut,
                    group_off: int, r1_read_off: int, r2_read_off: int,
                    mid_local: int, ov_off: int):
    """Remap one batch's screened pair columns and overlap columns from
    batch-local to chunk-global ids, so batches can be concatenated for
    the chunk-wide pseudo-assembly (chains span batches,
    PairedOverlap.h:480-576).  Returns (cols_global, overlap columns)."""
    valid = cols.valid
    cols_g = cols._replace(
        group=torch.where(valid, cols.group + group_off, 0),
        r1_idx=torch.where(cols.r1_idx >= 0, cols.r1_idx + ov_off,
                           cols.r1_idx),
        r2_idx=torch.where(cols.r2_idx >= 0, cols.r2_idx + ov_off,
                           cols.r2_idx))
    r = a.overlaps.read_id
    if mid_local > 0:
        r_global = torch.where(r >= mid_local, r - mid_local + r2_read_off,
                               r + r1_read_off)
    else:
        r_global = r + r1_read_off
    ov = (r_global, a.overlaps.entry_id, a.overlaps.rel_pos,
          a.overlaps.rc, a.ov_score, a.ov_begin, a.ov_end,
          a.ov_qbegin, a.ov_qend)
    return cols_g, ov


def compact_cols(cols: screens_dev.PairCols) -> screens_dev.PairCols:
    """Stable front-compaction to exactly the valid rows."""
    sel = torch.argsort((~cols.valid).to(torch.int8),
                        stable=True)[:int(cols.valid.sum())]
    return screens_dev.PairCols(*(c[sel] for c in cols))


def rescore_sorted_host(valid, cs, score_u32, rsh, reh) -> np.ndarray:
    """Exact C++-double chain rescoring (PairedOverlap.h:517-573) over
    rows already in chain (entity, refStart) order: per-chain sums with
    float64 semantics via the native helper, Python fallback otherwise.
    Returns the new uint32 scores in the same order."""
    import math
    from ..io import native
    native_out = native.rescore_chains(valid, cs, score_u32, rsh, reh)
    if native_out is not None:
        return native_out
    score = score_u32.astype(np.int64)
    rs = rsh.astype(np.int64)
    re = reh.astype(np.int64)
    new_sorted = score.copy()
    vrows = np.flatnonzero(valid)
    if len(vrows):
        vcs = cs[vrows]
        starts = np.flatnonzero(np.concatenate(
            [[True], vcs[1:] != vcs[:-1]]))
        bounds = np.append(starts, len(vrows))
        for b in range(len(starts)):
            rows = vrows[bounds[b]:bounds[b + 1]]
            if len(rows) < 2:
                continue
            per_base = 0.0
            num_bases = 0
            highest = -1000000
            for k in rows:
                span = abs(int(re[k]) - int(rs[k]))
                per_base += (int(score[k]) / span) if span else \
                    float("inf")
                num_bases += span
                if int(re[k]) > highest:
                    highest = int(re[k])
            length = float(highest - int(rs[rows[0]]))
            if length != 0.0:
                cov = num_bases / length
            else:
                cov = float("nan") if num_bases == 0 else float("inf")
            avg = per_base / len(rows)
            val = cov * avg * length
            rescored = (int(val) & 0xFFFFFFFF) if math.isfinite(val) else 0
            new_sorted[rows] = rescored
    return new_sorted.astype(np.uint32)


def apply_rescored(cols: screens_dev.PairCols, rows, new_scores
                   ) -> screens_dev.PairCols:
    """Scatter host-rescored chain scores back into the column."""
    return cols._replace(
        combined_score=cols.combined_score.index_put((rows,), new_scores))


def rescore_chains(cols: screens_dev.PairCols, perm, cseg
                   ) -> screens_dev.PairCols:
    """Exact host rescoring of the chains with >= 2 valid members
    (PairedOverlap.h:534-541 rescores chainLength > 1): only those rows
    cross to the host, in chain order, and their new scores are
    scattered back."""
    pp = cols.group.shape[0]
    v = cols.valid[perm]
    members = torch.zeros(pp, dtype=torch.int64, device=v.device) \
        .scatter_add(0, cseg, v.to(torch.int64))
    sel = torch.nonzero(v & (members[cseg] >= 2)).reshape(-1)
    if not len(sel):
        return cols
    rows = perm[sel]
    with metrics.stage("phase_b_rescore"):
        sc = (cols.combined_score[rows] & 0xFFFFFFFF).cpu().numpy() \
            .astype(np.uint32)
        cs = cseg[sel].cpu().numpy().astype(np.int32)
        new = rescore_sorted_host(
            np.ones(len(sc), bool), cs, sc,
            cols.ref_start[rows].cpu().numpy(),
            cols.ref_end[rows].cpu().numpy())
        metrics.count("rows", len(cs))
        metrics.count("chains", int(np.count_nonzero(cs[1:] != cs[:-1])) + 1)
        new_i64 = torch.as_tensor(
            new.astype(np.uint32).view(np.int32).astype(np.int64),
            device=rows.device)
    return apply_rescored(cols, rows, new_i64)


def phase_b(a: PhaseAOut, midpoint, max_insert, entry_taxids, lca_tables,
            fraction: float, perform_pseudo_assembly: bool,
            paired: bool = True) -> PhaseBOut:
    """Phase B of one batch with the float32 device pseudo-assembly
    rescoring (screens_dev.pseudo_assembly_device), the reference
    package's dry-run and probe path; the CLI pipeline runs
    run_chunk_phase_b, which rescores chains exactly on the host.
    Composition of phase_b_screens + phase_b_finish."""
    cols = phase_b_screens(a, midpoint, max_insert, fraction=fraction,
                           paired=paired)
    if perform_pseudo_assembly:
        cols = screens_dev.pseudo_assembly_device(cols)
    return phase_b_finish(cols, entry_taxids, lca_tables, fraction=fraction,
                          rescreen=perform_pseudo_assembly)


def phase_b_finish(cols: screens_dev.PairCols, entry_taxids, lca_tables,
                   fraction: float, rescreen: bool) -> PhaseBOut:
    """Final screen + group sort (valid rows first) + per-read LCA."""
    if rescreen:
        cols = screens_dev.screen_by_score_device(cols, fraction)
    pp = cols.group.shape[0]
    dev = cols.group.device
    perm = screens_dev._sort_perm(cols.valid, cols.group,
                                  torch.arange(pp, dtype=torch.int64,
                                               device=dev))
    cols = screens_dev._permute(cols, perm)
    taxids = entry_taxids[torch.clamp(cols.entry_id.to(torch.int64), min=0)]
    first = (shift1(cols.group, -1) != cols.group) | \
        (shift1(cols.valid, True) != cols.valid)
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    seg_lca = lca_ops.lca_segments_reduce(taxids, seg, cols.valid,
                                          lca_tables, num_segments=pp)
    read_lca = seg_lca[seg]
    nxt_seg = torch.cat([seg[1:], torch.full((min(pp, 1),), -1,
                                             dtype=seg.dtype, device=dev)])
    group_last = cols.valid & (nxt_seg != seg)
    return PhaseBOut(cols, read_lca, group_last)


def run_chunk_phase_b(a_list, mid_local: int, chunk_mid: int, unit: int,
                      max_insert, entry_taxids, lca_tables, fraction: float,
                      perform_pseudo_assembly: bool, paired: bool = True):
    """Chunk-wide phase B over the per-batch PhaseAOut list, run in
    sequence: per-batch screens (read pairs never span batches), concat
    into chunk-global columns, ONE chunk-global pseudo-assembly with
    exact host rescoring, rescreen and finish -- the reference's
    per-chunk pseudoAssembly.  Returns (PhaseBOut, overlap columns)."""
    cols_parts, ov_parts = [], []
    ov_off = 0
    for i, a in enumerate(a_list):
        cols = phase_b_screens(a, mid_local, max_insert, fraction=fraction,
                               paired=paired)
        cols_g, ov = globalize_batch(cols, a, i * unit, i * unit,
                                     chunk_mid + i * unit, mid_local, ov_off)
        ov_off += a.overlaps.read_id.shape[0]
        cols_parts.append(compact_cols(cols_g))
        ov_parts.append(ov)
    cols = screens_dev.PairCols(
        *(torch.cat(parts) for parts in zip(*cols_parts)))
    ov_cols = tuple(torch.cat(parts) for parts in zip(*ov_parts))
    if perform_pseudo_assembly:
        perm, cseg = screens_dev.pseudo_assembly_chains(cols)
        cols = rescore_chains(cols, perm, cseg)
    b = phase_b_finish(cols, entry_taxids, lca_tables, fraction=fraction,
                       rescreen=perform_pseudo_assembly)
    return b, ov_cols


def fetch_host_pairs_arrays(b: PhaseBOut, ov_cols):
    """Host copies for chunk_to_host_pairs (SAM/object path) in one int64
    transfer: the overlap columns, and the surviving rows of the pair
    columns (phase_b_finish puts the valid rows first).  Returns (overlap
    columns, (valid, group, r1_idx, r2_idx, score, entry_id, ref_start,
    ref_end, insert_size, read_lca, group_last))."""
    n = int(b.cols.valid.sum())
    cols = (b.cols.valid, b.cols.group, b.cols.r1_idx, b.cols.r2_idx,
            b.cols.combined_score, b.cols.entry_id, b.cols.ref_start,
            b.cols.ref_end, b.cols.insert_size, b.read_lca, b.group_last)
    flat = torch.cat([c.to(torch.int64) for c in ov_cols] +
                     [c[:n].to(torch.int64) for c in cols]).cpu().numpy()
    n_ov = ov_cols[0].shape[0] * len(ov_cols)
    return (tuple(flat[:n_ov].reshape(len(ov_cols), -1)),
            tuple(flat[n_ov:].reshape(len(cols), n)))


def chunk_to_host_pairs(b: PhaseBOut, ov_cols, chunk_mid: int,
                        fetched=None):
    """The host object model (ReadPairAlignments per read, with their
    PairedOverlaps and AlignedOverlaps) of run_chunk_phase_b's result, for
    SAM emission and gene assignment; returns (reads, {r1 position: read
    LCA}).  Overlap read ids and groups are already chunk-global
    (globalize_batch), so no offsets are added here."""
    from .pairing import (AlignedOverlap, PairedOverlap,
                          ReadPairAlignments)
    if fetched is None:
        fetched = fetch_host_pairs_arrays(b, ov_cols)
    (ov_read, ov_entry, ov_rel, ov_rc, ov_score, ov_begin, ov_end,
     ov_qb, ov_qe) = fetched[0]
    overlap_cache = {}

    def overlap_of(j):
        if j < 0:
            return None
        o = overlap_cache.get(j)
        if o is None:
            o = AlignedOverlap(
                read_id=int(ov_read[j]), entry_id=int(ov_entry[j]),
                rel_pos=int(ov_rel[j]), rc=bool(ov_rc[j]),
                score=int(ov_score[j]), ref_begin=int(ov_begin[j]),
                ref_end=int(ov_end[j]), query_begin=int(ov_qb[j]),
                query_end=int(ov_qe[j]))
            overlap_cache[j] = o
        return o

    (valid, group, r1i, r2i, sc, en, rs, re, ins, lca, last) = fetched[1]
    reads = []
    lcas = {}
    current = None
    for i in np.nonzero(valid)[0]:
        g = int(group[i])
        if current is None or current.r1_pos != g:
            current = ReadPairAlignments(
                g, g + chunk_mid if chunk_mid else g, [])
            reads.append(current)
        current.pairs.append(PairedOverlap(
            combined_score=int(sc[i]) & 0xFFFFFFFF, entry_id=int(en[i]),
            ref_start=int(rs[i]), ref_end=int(re[i]),
            insert_size=int(ins[i]), r1=overlap_of(int(r1i[i])),
            r2=overlap_of(int(r2i[i]))))
        if last[i]:
            lcas[g] = int(lca[i])
    return reads, lcas
