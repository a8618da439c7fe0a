"""Smith-Waterman of each candidate on its flat window.

Frozen copy of kslam_tpu_torch's ops/sw.align_overlaps_batch (the
reference window at max(rel, 0), the read's length of it, clipped at
the entry end, reverse-complemented for RC overlaps) over
ops/sw_cuda.sw_align_batch_plain (a forward column scan, the reverse
gather of the aligned prefixes, the forward scan again).  The tie-break
is the reference's: the highest score, then the smallest ref column,
then the smallest query row.  Codes A/C/T/G = 0..3, N = 4 scores 0.

`saturate` caps every cell at that score, as an 8-bit striped kernel
without its 16-bit retry would: the control's lower precision.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -(1 << 20)


class Alignments(NamedTuple):
    score: torch.Tensor
    ref_begin: torch.Tensor
    ref_end: torch.Tensor
    query_begin: torch.Tensor
    query_end: torch.Tensor


def forward(q, r, match, mismatch, go, ge, saturate=None):
    """(score, ref_end, read_end) of each row of q [B, Lq] against
    r [B, Lr]: a column scan over r with F as an exact exclusive prefix
    max down the query axis."""
    dev = q.device
    b, lq = q.shape
    idx = torch.arange(lq, dtype=torch.int32, device=dev)[None, :]
    q_n = q == 4
    zeros_col = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    neg_col = torch.full((b, 1), NEG, dtype=torch.int32, device=dev)
    h_prev = torch.zeros((b, lq), dtype=torch.int32, device=dev)
    e_prev = torch.zeros((b, lq), dtype=torch.int32, device=dev)
    best = torch.zeros(b, dtype=torch.int32, device=dev)
    best_col = torch.full((b,), -1, dtype=torch.int32, device=dev)
    best_h = torch.zeros((b, lq), dtype=torch.int32, device=dev)
    for j in range(r.shape[1]):
        rj = r[:, j:j + 1]
        s = torch.where(q_n | (rj == 4), 0,
                        torch.where(q == rj, match, -mismatch))
        diag = torch.cat([zeros_col, h_prev[:, :-1]], dim=1)
        h = torch.clamp(diag + s, min=0)
        h = torch.maximum(h, e_prev)
        a = h - go + idx * ge
        f = torch.cummax(torch.cat([neg_col, a[:, :-1]], dim=1),
                         dim=1).values - (idx - 1) * ge
        h = torch.maximum(h, f)
        if saturate is not None:
            h = torch.clamp(h, max=saturate)
        e_prev = torch.clamp(torch.maximum(h - go, e_prev - ge), min=0)
        colmax = h.max(dim=1).values
        improved = colmax > best
        best = torch.where(improved, colmax, best)
        best_col = torch.where(improved, j, best_col)
        best_h = torch.where(improved[:, None], h, best_h)
        h_prev = h
    read_end = torch.argmax((best_h == best[:, None]).to(torch.int32),
                            dim=1).to(torch.int32)
    zero = best == 0
    return (best, torch.where(zero, -1, best_col).to(torch.int32),
            torch.where(zero, 0, read_end).to(torch.int32))


def _reverse_gather(x, end):
    b, l = x.shape
    j = torch.arange(l, dtype=torch.int64, device=x.device)[None, :]
    src = end.to(torch.int64)[:, None] - j
    vals = torch.gather(x, 1, torch.clamp(src, 0, l - 1))
    return torch.where(src >= 0, vals, torch.full_like(vals, 4))


def align(q, r, match, mismatch, go, ge, saturate=None) -> Alignments:
    """Scores, begin and end positions in window coordinates."""
    score, ref_end, read_end = forward(q, r, match, mismatch, go, ge,
                                       saturate)
    rev = forward(_reverse_gather(q, read_end), _reverse_gather(r, ref_end),
                  match, mismatch, go, ge, saturate)
    zero = score == 0
    ref_begin = torch.where(zero, -1, ref_end - rev[1])
    query_begin = torch.where(zero, 0, read_end - rev[2])
    return Alignments(score, ref_begin.to(torch.int32), ref_end,
                      query_begin.to(torch.int32), read_end)


def align_candidates(read_id, entry_id, rel_pos, rc, read_scodes,
                     read_lengths, genome_scodes, entry_offsets, sw,
                     window_len: int, block: int = 1 << 18,
                     saturate=None) -> Alignments:
    """performSmithWatermanOnRange2 (SmithWaterman.h:184-233) of every
    candidate, `block` candidates at a time; coordinates in the forward
    entry.  sw = (match, mismatch, gap_open, gap_extend)."""
    parts = []
    for a in range(0, read_id.shape[0], block):
        s = slice(a, a + block)
        parts.append(_align_block(read_id[s], entry_id[s], rel_pos[s], rc[s],
                                  read_scodes, read_lengths, genome_scodes,
                                  entry_offsets, sw, window_len, saturate))
    if not parts:
        z = torch.zeros(0, dtype=torch.int32, device=read_id.device)
        return Alignments(z, z, z, z, z)
    return Alignments(*(torch.cat(c) for c in zip(*parts)))


def _align_block(read_id, entry_id, rel_pos, rc, read_scodes, read_lengths,
                 genome_scodes, entry_offsets, sw, window_len, saturate):
    dev = read_scodes.device
    safe_read = read_id.to(torch.int64)
    safe_entry = entry_id.to(torch.int64)
    qlen = read_lengths[safe_read].to(torch.int32)
    ref_start = torch.clamp(rel_pos.to(torch.int32), min=0)
    e_off = entry_offsets[safe_entry].to(torch.int64)
    e_len = (entry_offsets[safe_entry + 1].to(torch.int64) - e_off) \
        .to(torch.int32)
    wlen = torch.minimum(torch.clamp(e_len - ref_start, min=0), qlen)
    j = torch.arange(window_len, dtype=torch.int32, device=dev)[None, :]
    pos = torch.where(rc[:, None], wlen[:, None] - 1 - j, j)
    in_window = (pos >= 0) & (pos < wlen[:, None])
    g_idx = torch.clamp(e_off[:, None] + ref_start[:, None].to(torch.int64)
                        + pos, 0, genome_scodes.shape[0] - 1)
    window = genome_scodes[g_idx].to(torch.int32)
    window = torch.where(rc[:, None] & (window < 4), window ^ 2, window)
    window = torch.where(in_window, window, torch.full_like(window, 4))
    q = read_scodes[safe_read].to(torch.int32)
    q = torch.where(j < qlen[:, None], q, torch.full_like(q, 4))
    al = align(q, window, *sw, saturate=saturate)
    rb = torch.where(rc, wlen - 1 - al.ref_end, al.ref_begin)
    re = torch.where(rc, wlen - 1 - al.ref_begin, al.ref_end)
    qb = torch.where(rc, qlen - 1 - al.query_end, al.query_begin)
    qe = torch.where(rc, qlen - 1 - al.query_begin, al.query_end)
    return Alignments(al.score, rb + ref_start, re + ref_start, qb, qe)
