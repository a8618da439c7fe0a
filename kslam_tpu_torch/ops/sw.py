"""Batched Smith-Waterman around the device kernel: result types, the
candidate window builders (chunked for the device pipeline, flat for the
host-object path) and the begin-position reverse pass.

Counterpart of kslam_tpu/ops/sw.py.  The alignment itself (score, begin
and end positions, the reference's tie-break contract: max score, then
the smallest ref column, then the smallest query row) is
ops/sw_cuda.sw_align_batch: the hand-written fused CUDA kernel for CUDA
tensors, its plain torch composition for CPU tensors.  Codes are
A/C/T/G = 0..3 and N = 4; N scores 0 and doubles as padding.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

CHUNK = 32  # genome chunk width of the window builder: a 160-base window
            # scans nch * CHUNK = 192 ref columns


class SWEnds(NamedTuple):
    score: torch.Tensor     # int32 [B]
    ref_end: torch.Tensor   # int32 [B], -1 when score == 0
    read_end: torch.Tensor  # int32 [B], 0 when score == 0


class SWAlignments(NamedTuple):
    score: torch.Tensor
    ref_begin: torch.Tensor
    ref_end: torch.Tensor
    query_begin: torch.Tensor
    query_end: torch.Tensor


def check_params(p) -> None:
    """Scoring parameters the reference's striped kernel and this batched
    formulation agree on (kslam_tpu/golden/ssw.py:check_params)."""
    if not (2 * p.gap_open > p.match + p.mismatch and
            p.gap_open >= p.gap_extend >= 1):
        raise ValueError(
            "SW params admit insertion-adjacent-to-deletion optima; "
            "golden model would diverge from the striped reference "
            "kernel: %r" % (p,))


def sw_forward_batch(q, r, match: int, mismatch: int, gap_open: int,
                     gap_extend: int, n_valid=None) -> SWEnds:
    """Forward pass over q [B, Lq] and r [B, Lr] (see ops/sw_cuda.py)."""
    from . import sw_cuda
    return sw_cuda.sw_forward_batch(q, r, match, mismatch, gap_open,
                                    gap_extend, n_valid=n_valid)


def _reverse_gather(x, end):
    """x: [B, L]; per-row reversed prefix x[end], x[end-1], ..., x[0],
    padded with N (4)."""
    b, l = x.shape
    j = torch.arange(l, dtype=torch.int64, device=x.device)[None, :]
    src = end.to(torch.int64)[:, None] - j
    vals = torch.gather(x, 1, torch.clamp(src, 0, l - 1))
    return torch.where(src >= 0, vals, torch.full_like(vals, 4))


def genome_chunks_from_scodes(scodes: np.ndarray) -> np.ndarray:
    """Host: pad SW codes to a CHUNK multiple (with N) and reshape to
    [G/CHUNK, CHUNK] rows for coarse row-gathers."""
    g = len(scodes)
    padded = np.full(((g + CHUNK - 1) // CHUNK) * CHUNK, 4, np.uint8)
    padded[:g] = scodes
    return padded.reshape(-1, CHUNK)


def align_overlaps_batch(read_id, entry_id, rel_pos, rc, valid,
                         read_scodes, read_lengths, genome_scodes,
                         entry_offsets, match: int, mismatch: int,
                         gap_open: int, gap_extend: int,
                         window_len: int) -> SWAlignments:
    """performSmithWatermanOnRange2 (SmithWaterman.h:184-233), batched
    over the flat [G] genome codes: slice the ref window at max(rel, 0)
    of query length (clipped at the entry end), reverse-complement it for
    RC overlaps, align (sw_cuda.sw_align_batch: the kernel's forward and
    reverse passes), flip RC coordinates back to forward-ref space, then
    add the window start.  window_len is the padded length (>= the
    longest read).  Rows of invalid candidates produce arbitrary
    results; callers filter."""
    from . import sw_cuda
    dev = read_scodes.device
    safe_read = torch.clamp(read_id.to(torch.int64), 0,
                            read_scodes.shape[0] - 1)
    safe_entry = torch.clamp(entry_id.to(torch.int64), 0,
                             entry_offsets.shape[0] - 2)
    qlen = read_lengths[safe_read].to(torch.int32)
    ref_start = torch.clamp(rel_pos.to(torch.int32), min=0)
    e_off = entry_offsets[safe_entry].to(torch.int64)
    e_len = (entry_offsets[safe_entry + 1].to(torch.int64) - e_off) \
        .to(torch.int32)
    wlen = torch.minimum(torch.clamp(e_len - ref_start, min=0), qlen)

    j = torch.arange(window_len, dtype=torch.int32, device=dev)[None, :]
    # forward window positions; RC rows read the window reversed
    pos = torch.where(rc[:, None], wlen[:, None] - 1 - j, j)
    in_window = (pos >= 0) & (pos < wlen[:, None])
    g_idx = torch.clamp(e_off[:, None] + ref_start[:, None].to(torch.int64)
                        + pos, 0, genome_scodes.shape[0] - 1)
    window = genome_scodes[g_idx].to(torch.int32)
    window = torch.where(rc[:, None] & (window < 4), window ^ 2, window)
    window = torch.where(in_window, window, torch.full_like(window, 4))

    q = read_scodes[safe_read].to(torch.int32)
    q = torch.where(j < qlen[:, None], q, torch.full_like(q, 4))
    al = sw_cuda.sw_align_batch(q, window, match, mismatch, gap_open,
                                gap_extend)

    # RC coordinate flip (SmithWaterman.h:212-227), applied to every RC
    # row like the reference (score-0 rows included)
    rb = torch.where(rc, wlen - 1 - al.ref_end, al.ref_begin)
    re = torch.where(rc, wlen - 1 - al.ref_begin, al.ref_end)
    qb = torch.where(rc, qlen - 1 - al.query_end, al.query_begin)
    qe = torch.where(rc, qlen - 1 - al.query_begin, al.query_end)
    return SWAlignments(al.score, rb + ref_start, re + ref_start, qb, qe)


class ChunkedWindows(NamedTuple):
    q: torch.Tensor          # int32 [B, Lq] query codes, N past qlen
    r: torch.Tensor          # int32 [B, W] ref window, N outside it
    dstart: torch.Tensor     # int32 [B] the window's first column in r
    wlen: torch.Tensor       # int32 [B] window length
    qlen: torch.Tensor       # int32 [B] query length
    ref_start: torch.Tensor  # int32 [B] window start in the entry


def chunked_windows(read_id, entry_id, rel_pos, rc, read_scodes,
                    read_lengths, genome_chunks, entry_offsets,
                    window_len: int) -> ChunkedWindows:
    """The windows of align_overlaps_batch_chunked: the reference window
    (at max(rel, 0), query length, clipped at the entry end,
    reverse-complemented for RC overlaps) assembled from W = nch * CHUNK
    columns of CHUNK-aligned genome rows, N outside it, and the query
    padded with N past its length."""
    dev = read_scodes.device
    lq = window_len
    nch = (window_len + CHUNK - 1) // CHUNK + 1
    w = nch * CHUNK
    safe_read = torch.clamp(read_id.to(torch.int64), 0,
                            read_scodes.shape[0] - 1)
    safe_entry = torch.clamp(entry_id.to(torch.int64), 0,
                             entry_offsets.shape[0] - 2)
    qlen = read_lengths[safe_read].to(torch.int32)
    ref_start = torch.clamp(rel_pos.to(torch.int32), min=0)
    e_off = entry_offsets[safe_entry].to(torch.int64)
    e_len = (entry_offsets[safe_entry + 1].to(torch.int64) - e_off) \
        .to(torch.int32)
    wlen = torch.minimum(torch.clamp(e_len - ref_start, min=0), qlen)

    g0 = e_off + ref_start.to(torch.int64)
    base = g0 // CHUNK
    d = (g0 % CHUNK).to(torch.int32)
    nblocks = genome_chunks.shape[0]
    rows = torch.clamp(
        base[:, None] + torch.arange(nch, dtype=torch.int64,
                                     device=dev)[None, :],
        0, max(nblocks - 1, 0))
    buf = genome_chunks[rows].reshape(-1, w).to(torch.int32)   # [B, W]

    j = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    four = torch.full_like(buf, 4)
    in_fwd = (j >= d[:, None]) & (j < (d + wlen)[:, None])
    fwd_r = torch.where(in_fwd, buf, four)
    flip = torch.flip(buf, dims=[1])
    d2 = w - d - wlen
    in_rc = (j >= d2[:, None]) & (j < (d2 + wlen)[:, None])
    rc_r = torch.where(in_rc, torch.where(flip < 4, flip ^ 2, flip), four)
    r = torch.where(rc[:, None], rc_r, fwd_r)
    dstart = torch.where(rc, d2, d)

    q = read_scodes[safe_read].to(torch.int32)
    jq = torch.arange(lq, dtype=torch.int32, device=dev)[None, :]
    qm = torch.where(jq < qlen[:, None], q, torch.full_like(q, 4))
    return ChunkedWindows(qm, r, dstart, wlen, qlen, ref_start)


def chunked_coordinates(al: SWAlignments, win: ChunkedWindows,
                        rc) -> SWAlignments:
    """Window-coordinate alignments of chunked_windows' windows to
    forward-ref entry coordinates: the window's first column off, the RC
    flip (SmithWaterman.h:212-227, score-0 rows included), the window
    start on."""
    zero = al.score == 0
    minus1 = torch.full_like(al.score, -1)
    k_end = torch.where(zero, minus1, al.ref_end - win.dstart)
    k_begin = torch.where(zero, minus1, al.ref_begin - win.dstart)
    rb = torch.where(rc, win.wlen - 1 - k_end, k_begin)
    re = torch.where(rc, win.wlen - 1 - k_begin, k_end)
    qb = torch.where(rc, win.qlen - 1 - al.query_end, al.query_begin)
    qe = torch.where(rc, win.qlen - 1 - al.query_begin, al.query_end)
    return SWAlignments(al.score, rb + win.ref_start, re + win.ref_start,
                        qb, qe)


def align_overlaps_batch_chunked(read_id, entry_id, rel_pos, rc, valid,
                                 read_scodes, read_lengths,
                                 genome_chunks, entry_offsets,
                                 match: int, mismatch: int, gap_open: int,
                                 gap_extend: int, window_len: int,
                                 n_valid=None) -> SWAlignments:
    """performSmithWatermanOnRange2 (SmithWaterman.h:184-233), batched:
    the reference window (at max(rel, 0), query length, clipped at the
    entry end, reverse-complemented for RC overlaps) is assembled from
    CHUNK-aligned genome rows with per-row masks (chunked_windows) and
    aligned (sw_cuda.sw_align_batch: one fused launch of the forward and
    reverse passes on CUDA); RC coordinates are flipped back to
    forward-ref space and the window start is added.

    Leading N rows/columns stay zero in the DP and trailing-N cells only
    tie real maxima at later columns/rows, which the tie-break rejects,
    so the masked wide window equals the compact-window result, and the
    reverse pass over the aligned prefixes equals the reference package's
    reverse pass on fixed flips.  Rows of invalid candidates produce
    arbitrary results; callers filter."""
    from . import sw_cuda
    win = chunked_windows(read_id, entry_id, rel_pos, rc, read_scodes,
                          read_lengths, genome_chunks, entry_offsets,
                          window_len)
    al = sw_cuda.sw_align_batch(win.q, win.r, match, mismatch, gap_open,
                                gap_extend, n_valid=n_valid)
    return chunked_coordinates(al, win, rc)
