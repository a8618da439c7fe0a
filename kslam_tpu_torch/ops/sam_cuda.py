"""The SAM path's two hand-written kernels (csrc/sam.cu), their launch
glue and their plain torch versions.

sam_cigar computes, for each SAM alignment, what the native host call
kslam_ssw_cigar_batch (csrc/ssw_batch.cc) computes for one overlap: the
query against its native window (the entry sliced at max(rel_pos, 0),
of query length, clipped at the entry's end, reverse-complemented in SW
codes for rc), the forward pass's ends, the reverse pass over the
reversed prefixes, the banded DP and traceback with band doubling, the
reference's direction preferences, the merged leading-M row-0 rule, the
overflow abort (cigar_len -1, score zeroed) and the score_filter skip
(-2), then the coordinates un-flipped and the cigar reversed for rc.
Outputs: score, ref_begin, ref_end, query_begin, query_end (int32, the
begins and ends in entry coordinates), cigar_buf (int32 [n, C], runs
len << 4 | op, op 0 = M, 1 = I, 2 = D) and cigar_len.

sam_diff is io/sam.get_cigar_and_md per alignment: from the cigar runs
and the overlap's own query_begin / query_end and a reference window
starting at its ref_begin, the CIGAR text with its soft clips, the MD
text (the walk's components merged as its loop merges them: summed
numbers, `^` runs, the "0" after a deletion), NM, and the log10
probability as float64, summed in the walk's order from its two tables.
It compares ASCII bytes: the query is the read or its
reverse_complement_str, the quality string reversed for rc; a position
past the reference's end reads NUL, one past the read NUL with quality 1.
cigar_len below -2 (NO_CIGAR) stands for a cigar of None: the empty
diff; -1 and -2 stand for [] (compute_cigars_batch's `c if c is not None
else []`): only the soft clips.

Neither replaces a Pallas kernel: they replace host C++ (OpenMP) and host
Python.  What bounds them on the H100: sam_cigar is integer work, the
forward and reverse passes over ~2 x 150 x 150 cells an alignment (the
banded DP is a few cells a row).  A batch is two launches: the passes,
sw_align's register wavefront (csrc/sw_group.cuh) with the native
windows staged as score words in shared memory, a group of G lanes an
alignment; then the band kernel, a group of 8 lanes an alignment in the
warp's lockstep, each band row's cells over the lanes, its band rows and
direction bytes in shared memory for half-widths up to W_CAP, the
traceback on the group's first lane.  sam_diff reads a read, its quality
and a window and writes two short texts: bytes, and a float64 chain; one
lane an alignment, a warp's lanes in lockstep over their staged rows.
Both launch in batches of BATCH alignments.  The rows whose
band outgrows W_CAP (REDO) or whose cigar outgrows OPS_CAP runs
(REDO_OPS) are taken with one nonzero and get the band kernel again, a
warp an alignment, its region in a device slab for any band their
lengths allow (the attempts already made skipped); sam_diff writes its
texts up to the caps given and reports the lengths they need, and the
caller relaunches the rows that did not fit.

A batch past the group kernels' limits (reads' stride or windows over
1024, match x stride over 2047: the packed key's fields; gap_open <
gap_extend, where the wavefront's F differs from the native's) runs
sam_cigar_long, one thread an alignment (the native code's loops in its
order, its band in device slabs), counted under its own name.

On a CPU tensor the wrappers run the plain versions (vectorised over
alignments); on a CUDA tensor they launch the kernel or raise: there is
no fallback.  SAM_LAUNCHES counts the launches of each __global__
function where it is launched: sam_cigar the passes kernel's, sam_band
the band kernel's (the first launch and the relaunch), sam_cigar_long
and sam_diff their own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cuda_lib import load_library
from .encode import _SW_TABLE
from .sw_cuda import SMEM_BLOCK_LIMIT, launch_config

SAM_LAUNCHES = {"sam_cigar": 0, "sam_band": 0, "sam_cigar_long": 0,
                "sam_diff": 0}

ABORTED = -1          # the banded DP's overflow abort: score zeroed
FILTERED = -2         # score under score_filter: no cigar
REDO = -3             # the band outgrew the kernel's region
REDO_OPS = -5         # the runs outgrew the kernel's run buffer (< REDO)
NO_CIGAR = -4         # sam_diff input: the cigar is None

BATCH = 1 << 15       # alignments a launch
W_CAP = 4             # band half-width the first launch's region holds
OPS_CAP = 32          # cigar runs the first launch's buffer holds
TEXT_CAP = 64         # CIGAR and MD bytes a row, first launch
GROUP_THREADS = 128   # sam_cigar's passes: a block, at most (kGroupThreads)
LONG_SMEM_TARGET = 200 * 1024  # sam_cigar_long: shared memory a block
LONG_THREADS = 32     # sam_cigar_long: threads a block, at most
WIDTH_LIMIT = 1 << 31      # ssw.c:631-642: width_d * read_len * 3
GROUP_CELLS = 1 << 20      # plain banded DP: one group up to this size

# reverse_complement_str (ops/encode.py) a byte at a time
_RC_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACTGactg", b"TGACtgac"):
    _RC_TABLE[_a] = _b


# the constant tables on each device they were asked for: made once, so
# that a launch does not wait on a host copy
_TABLES = {}


def _table(name: str, device, make):
    key = (name, torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = make()
    return _TABLES[key]


def sw_table(device) -> torch.Tensor:
    """encode.sw_codes_np's ASCII -> SW code table (csrc/ssw_batch.cc's
    kSw.t) as a uint8 [256] tensor."""
    return _table("sw", device, lambda: torch.as_tensor(_SW_TABLE).to(
        device))


def rc_table(device) -> torch.Tensor:
    """reverse_complement_str's complement of one byte, uint8 [256]."""
    return _table("rc", device, lambda: torch.as_tensor(_RC_TABLE).to(
        device))


def quality_tables(device):
    """io/sam's _MATCH_TABLE and _MISMATCH_TABLE as float64 [100]
    tensors (the walk's own values, not recomputed)."""
    from ..io import sam as sam_io
    return _table("quality", device, lambda: tuple(
        torch.tensor(t, dtype=torch.float64, device=device)
        for t in (sam_io._MATCH_TABLE, sam_io._MISMATCH_TABLE)))


def native_max_ops(read_lengths) -> int:
    """native.ssw_cigar_batch's default max_ops for a batch's lengths."""
    return 2 * (int(np.max(read_lengths)) if len(read_lengths) else 0) + 8


# --- host windows -------------------------------------------------------

def gather_rows(bases: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                width: int) -> np.ndarray:
    """uint8 [n, width]: row k holds bases[starts[k]:starts[k] + lens[k]]
    (lens <= width), zero after."""
    n = len(starts)
    out = np.zeros((n, max(width, 1)), np.uint8)
    if n == 0 or width == 0:
        return out[:, :width]
    fits = starts + width <= len(bases)
    if len(bases) >= width and fits.any():
        view = np.lib.stride_tricks.sliding_window_view(bases, width)
        out[fits] = view[starts[fits]]
    for k in np.flatnonzero(~fits):
        out[k, :lens[k]] = bases[starts[k]:starts[k] + lens[k]]
    # past each row's length: zero (the view copied the next bases)
    out[np.arange(width)[None, :] >= lens[:, None]] = 0
    return out


def native_windows(bases: np.ndarray, entry_offsets: np.ndarray,
                   entry_id: np.ndarray, rel_pos: np.ndarray,
                   qlen: np.ndarray, width: int):
    """The native call's windows (ssw_batch.cc: the entry sliced at
    max(rel_pos, 0), of query length, clipped at the entry's end), as
    ASCII rows: (win uint8 [n, width], wlen int32, ref_start int32)."""
    offs = np.asarray(entry_offsets, np.int64)
    eid = np.asarray(entry_id, np.int64)
    ref_start = np.maximum(np.asarray(rel_pos, np.int64), 0)
    elen = offs[eid + 1] - offs[eid]
    wlen = np.clip(elen - ref_start, 0, np.asarray(qlen, np.int64))
    win = gather_rows(bases, offs[eid] + ref_start, wlen, width)
    return win, wlen.astype(np.int32), ref_start.astype(np.int32)


def diff_windows(bases: np.ndarray, entry_offsets: np.ndarray,
                 entry_id: np.ndarray, ref_begin: np.ndarray, width: int):
    """sam_diff's reference windows: the entry from each overlap's
    ref_begin, as Python indexes entry.bases (a negative position counts
    from the entry's end).  Returns (dwin uint8 [n, width], dlen int32:
    the bytes of the row, elen_rel int64: the entry's bases from
    ref_begin on, past which the walk reads NUL)."""
    offs = np.asarray(entry_offsets, np.int64)
    eid = np.asarray(entry_id, np.int64)
    rb = np.asarray(ref_begin, np.int64)
    elen = offs[eid + 1] - offs[eid]
    elen_rel = elen - rb
    dlen = np.clip(elen_rel, 0, width)
    neg = rb < 0
    dwin = gather_rows(bases, offs[eid] + np.where(neg, 0, rb),
                       np.where(neg, 0, dlen), width)
    for k in np.flatnonzero(neg):
        e0, n_e = offs[eid[k]], elen[k]
        pos = rb[k] + np.arange(dlen[k])
        pos = np.where(pos < 0, pos + n_e, pos)
        dwin[k, :dlen[k]] = bases[e0 + np.clip(pos, 0, max(n_e - 1, 0))]
    return dwin, dlen.astype(np.int32), elen_rel


# --- sam_cigar: plain version -------------------------------------------

def _sub(q, r, match: int, mismatch: int):
    """Substitution scores of codes q and r (N = 4 scores 0)."""
    s = torch.where(q == r, match, -mismatch)
    return torch.where((q == 4) | (r == 4), 0, s)


def forward_ends_plain(q, m, r, n, match, mismatch, go, ge):
    """sw_forward_ends (ssw_batch.cc:58-97) of every row: q int64 [B, M]
    codes (rows >= m ignored), r int64 [B, N] (columns >= n ignored).
    The F recurrence as a prefix max down each column (exact for
    gap_open >= gap_extend, which check_params requires).  Returns
    (score, ref_end, read_end) int64 [B]."""
    b, mm = q.shape
    dev = q.device
    best = torch.zeros(b, dtype=torch.int64, device=dev)
    if mm == 0:
        return best, torch.full_like(best, -1), best.clone()
    idx = torch.arange(mm, device=dev)
    rowok = idx[None, :] < m[:, None]
    h_col = torch.zeros(b, mm, dtype=torch.int64, device=dev)
    e_col = torch.zeros_like(h_col)
    best_col = torch.full_like(best, -1)
    best_row = torch.zeros_like(best)
    neg = -(1 << 40)
    zero = torch.zeros(b, 1, dtype=torch.int64, device=dev)
    for j in range(r.shape[1]):
        act = j < n
        diag = torch.cat([zero, h_col[:, :-1]], 1)
        h = (diag + _sub(q, r[:, j:j + 1], match, mismatch)).clamp_min(0)
        h = torch.maximum(h, e_col)
        a = h - go + idx * ge
        pref = torch.cat([torch.full_like(zero, neg),
                          torch.cummax(a[:, :-1], 1).values], 1)
        h = torch.maximum(h, pref - (idx - 1) * ge)
        e_new = torch.maximum(h - go, e_col - ge).clamp_min(0)
        hm = torch.where(rowok, h, -1)
        colmax = hm.max(1).values
        colrow = torch.where(hm == colmax[:, None], idx, mm).min(1).values
        upd = act & (colmax > best)
        best = torch.where(upd, colmax, best)
        best_col = torch.where(upd, j, best_col)
        best_row = torch.where(upd, colrow, best_row)
        h_col = torch.where(act[:, None], h, h_col)
        e_col = torch.where(act[:, None], e_new, e_col)
    none = best == 0
    return best, torch.where(none, -1, best_col), \
        torch.where(none, 0, best_row)


def _reversed_prefix(x, end):
    """x[b, end[b] - i] for i <= end[b] (0 elsewhere), and the lengths
    end + 1 (0 where end < 0)."""
    w = x.shape[1]
    i = torch.arange(w, device=x.device)
    src = end[:, None] - i[None, :]
    ok = src >= 0
    out = torch.gather(x, 1, src.clamp(0, max(w - 1, 0)))
    return torch.where(ok, out, 0), (end + 1).clamp_min(0)


def _decode_dir(cell, layer):
    """The direction value of a packed cell byte's layer (0 unwritten)."""
    v0 = torch.where((cell & 1) != 0, 3, 2)
    v1 = torch.where((cell & 2) != 0, 5, 4)
    v2 = cell >> 2
    v = torch.where(layer == 0, v0, torch.where(layer == 1, v1, v2))
    return torch.where(cell == 0, 0, v)


def _banded_dp(rd, read_len, rf, ref_len, w, match, mismatch, go, ge):
    """One attempt of banded_cigar's DP (ssw_batch.cc:104-158) for every
    row at its own band w: returns (max_score, packed directions [B,
    L * (2 w_max + 1)], each row's cells at i * (2 w + 1) + k).  The F
    recurrence along a band row as a prefix max (gap_open >=
    gap_extend); the band arrays' quirks (the edge and row-0 zeroing,
    E read in place, the last row's length carried over) as written."""
    b, lmax = rd.shape
    dev = rd.device
    width = 2 * w + 3
    width_d = 2 * w + 1
    wmax = int(w.max()) if b else 0
    hsz = max(2 * wmax + 5, 8)
    # one column more than used: writes of cells outside a row land there
    hb = torch.zeros(b, hsz + 1, dtype=torch.int64, device=dev)
    eb = torch.zeros_like(hb)
    hc = torch.zeros_like(hb)
    n_dirs = max(lmax * (2 * wmax + 1), 1)
    dirs = torch.zeros(b, n_dirs + 1, dtype=torch.int64, device=dev)
    max_score = torch.zeros(b, dtype=torch.int64, device=dev)
    ulast = torch.zeros(b, dtype=torch.int64, device=dev)
    cols = torch.arange(hsz + 1, device=dev)
    kk = torch.arange(2 * wmax + 1, device=dev)
    for i in range(lmax):
        live = i < read_len
        x_i = (i - w).clamp_min(0)
        x_im1 = (i - 1 - w).clamp_min(0)
        end = torch.minimum(i + w, ref_len - 1)
        n_cells = torch.where(live, (end - x_i + 1).clamp_min(0), 0)
        edge = torch.minimum(end + 1, width - 1)
        for arr in (hb, eb, hc):
            arr[:, 0] = torch.where(live, 0, arr[:, 0])
        for arr in (hb, eb):
            at = (cols[None, :] == edge[:, None]) & live[:, None]
            arr.masked_fill_(at, 0)
        valid = kk[None, :] < n_cells[:, None]
        u = (kk[None, :] + 1).expand(b, -1)
        s = (x_i - x_im1)[:, None]
        e_idx = (u + s).clamp(max=hsz - 1)
        d_idx = (u - 1 + s).clamp(max=hsz - 1)
        if i == 0:
            t1e = torch.full_like(u, -go)
            t2e = torch.full_like(u, -ge)
        else:
            t1e = torch.gather(hb, 1, e_idx) - go
            t2e = torch.gather(eb, 1, e_idx) - ge
        e_new = torch.maximum(t1e, t2e)
        d0 = t1e > t2e
        e1 = e_new.clamp_min(0)
        j = (x_i[:, None] + kk[None, :]).clamp(0, max(rf.shape[1] - 1, 0))
        rfj = torch.gather(rf, 1, j) if rf.shape[1] else torch.full_like(
            j, 4)
        t2d = torch.gather(hb, 1, d_idx) + _sub(rd[:, i:i + 1], rfj, match,
                                                mismatch)
        h0 = torch.maximum(e1, t2d)
        # f_k = max(f_{k-1} - ge, h_{k-1} - go), from f = 0 and hc[0] = 0
        a = h0 + kk[None, :] * ge
        pref = torch.cummax(torch.cat([torch.full_like(a[:, :1], -ge),
                                       a[:, :-1]], 1), 1).values
        f = torch.maximum(-(kk[None, :] + 1) * ge,
                          pref - go - (kk[None, :] - 1) * ge)
        f1 = f.clamp_min(0)
        h = torch.maximum(h0, f1)
        h_prev = torch.cat([torch.zeros_like(h[:, :1]), h[:, :-1]], 1)
        f_prev = torch.cat([torch.zeros_like(f[:, :1]), f[:, :-1]], 1)
        d1 = (h_prev - go) > (f_prev - ge)
        dv0 = torch.where(d0, 3, 2)
        dv1 = torch.where(d1, 5, 4)
        dv2 = torch.where(torch.maximum(e1, f1) <= t2d, 1,
                          torch.where(e1 > f1, dv0, dv1))
        packed = d0.long() | (d1.long() << 1) | (dv2 << 2)
        max_score = torch.maximum(
            max_score, torch.where(valid, h, 0).max(1).values
            if h.shape[1] else max_score)
        uw = torch.where(valid, u, hsz)
        eb.scatter_(1, uw, e_new)
        hc.scatter_(1, uw, h)
        dirs.scatter_(1, torch.where(
            valid, i * width_d[:, None] + kk[None, :], n_dirs), packed)
        ulast = torch.where(live & (n_cells > 0), n_cells, ulast)
        cp = live[:, None] & (cols[None, :] >= 1) & \
            (cols[None, :] <= ulast[:, None])
        hb = torch.where(cp, hc, hb)
    return max_score, dirs[:, :n_dirs]


def _traceback(dirs, read_len, ref_len, w, max_ops: int):
    """The traceback (ssw_batch.cc:160-199) over packed directions: runs
    in traceback order [B, read_len + ref_len + 3] and their count, -1
    on a trace back error, a read outside the slab or more than max_ops
    runs."""
    b = dirs.shape[0]
    dev = dirs.device
    width_d = 2 * w + 1
    total = read_len * width_d * 3
    cap = int((read_len + ref_len).max()) + 3 if b else 3
    runs = torch.zeros(b, cap + 1, dtype=torch.int64, device=dev)
    n_runs = torch.zeros(b, dtype=torch.int64, device=dev)
    i = read_len - 1
    j = ref_len - 1
    e = torch.zeros_like(n_runs)
    f = torch.zeros_like(n_runs)
    run_op = torch.zeros_like(n_runs)
    temp2 = torch.full_like(n_runs, 2)
    err = torch.zeros(b, dtype=torch.bool, device=dev)

    def push(mask, val):
        nonlocal n_runs
        at = torch.where(mask & (n_runs < cap), n_runs, cap)
        runs.scatter_(1, at[:, None], val[:, None])
        n_runs = n_runs + mask.long()

    while True:
        act = (i > 0) & ~err
        if not bool(act.any()):
            break
        x = (i - w).clamp_min(0)
        idx = i * width_d * 3 + (j - x) * 3 + temp2
        inside = (idx >= 0) & (idx < total)
        cell = torch.gather(dirs, 1, (idx // 3).clamp(
            0, dirs.shape[1] - 1)[:, None])[:, 0]
        d = torch.where(inside, _decode_dir(cell, idx % 3), 0)
        bad = act & ((d < 1) | (d > 5))
        err = err | bad
        go_ = act & ~bad
        diag, ins, dlt = go_ & (d == 1), go_ & ((d == 2) | (d == 3)), \
            go_ & ((d == 4) | (d == 5))
        i = torch.where(diag | ins, i - 1, i)
        j = torch.where(diag | dlt, j - 1, j)
        temp2 = torch.where(go_, torch.where(
            d == 2, 0, torch.where(d == 4, 1, 2)), temp2)
        f = torch.where(diag, 0, torch.where(ins, 1, torch.where(dlt, 2, f)))
        same = go_ & (f == run_op)
        e = torch.where(same, e + 1, e)
        new = go_ & (f != run_op)
        err = err | (new & (n_runs >= 4094))
        new = new & ~err
        push(new, (e << 4) | run_op)
        run_op = torch.where(new, f, run_op)
        e = torch.where(new, 1, e)
    ok = ~err
    m0 = ok & (f == 0)
    push(m0, (e + 1) << 4)
    m1 = ok & (f != 0)
    push(m1, (e << 4) | f)
    push(m1, torch.full_like(e, 1 << 4))
    n_runs = torch.where(err | (n_runs > max_ops), -1, n_runs)
    return runs[:, :cap], n_runs


def banded_cigar_plain(rd, read_len, rf, ref_len, score, band, params,
                       max_ops: int):
    """banded_cigar (ssw_batch.cc:104-200) of every row: rd int64 [B, L]
    read codes (the [begin..end] sub-sequence), rf int64 [B, R] ref
    codes, their lengths, the forward score and the first band width.
    The band doubles while the DP's max is under the score; once the band
    covers every cell (w >= read_len - 1 and w >= ref_len - 1) every wider
    band repeats the same DP, so the native's doubling up to its width
    check (ssw.c:631-642) ends in the abort, returned here at once.
    Returns (runs [B, C] in traceback order, their count or -1, the last
    band width tried)."""
    match, mismatch, go, ge = (int(x) for x in params)
    if go < ge:
        raise ValueError("sam_cigar_plain needs gap_open >= gap_extend")
    b = rd.shape[0]
    dev = rd.device
    cap = int((read_len + ref_len).max()) + 3 if b else 3
    runs = torch.zeros(b, cap, dtype=torch.int64, device=dev)
    n_runs = torch.full((b,), -1, dtype=torch.int64, device=dev)
    w = band.clone().long()
    todo = torch.ones(b, dtype=torch.bool, device=dev)
    while bool(todo.any()):
        over = todo & ((2 * w + 1) * read_len * 3 >= WIDTH_LIMIT)
        todo = todo & ~over
        if not bool(todo.any()):
            break
        # rows of one band size class at a time where the batch is large:
        # a DP step spans the widest band of its rows
        size = torch.floor(torch.log2(w.clamp_min(1).double())).long()
        if int(todo.sum()) * (2 * int(w[todo].max()) + 1) <= GROUP_CELLS:
            size = torch.zeros_like(size)
        for cls in torch.unique(size[todo]).tolist():
            sel = torch.nonzero(todo & (size == cls)).flatten()
            ms, dirs = _banded_dp(rd[sel], read_len[sel], rf[sel],
                                  ref_len[sel], w[sel], match, mismatch, go,
                                  ge)
            ok = ms >= score[sel]
            if bool(ok.any()):
                s_ok = sel[ok]
                r_ok, n_ok = _traceback(dirs[ok], read_len[s_ok],
                                        ref_len[s_ok], w[s_ok], max_ops)
                runs[s_ok, :r_ok.shape[1]] = r_ok[:, :cap]
                n_runs[s_ok] = n_ok
            covered = (w[sel] >= read_len[sel] - 1) & \
                (w[sel] >= ref_len[sel] - 1)
            todo[sel[ok | covered]] = False
            w[sel[~ok & ~covered]] *= 2
    return runs, n_runs, w


def sam_cigar_plain(reads, read_len, read_id, rc, win, wlen, ref_start,
                    params, score_filter: int = 0, max_ops: int = 0):
    """The plain version of sam_cigar (kslam_ssw_cigar_batch, report_cigar
    on), vectorised over alignments: reads uint8 [n_reads, stride] ASCII,
    read_len int32 [n_reads]; per alignment read_id, rc, its native window
    win uint8 [n, W] (ASCII) of wlen bases and ref_start (int32).
    params: (match, mismatch, gap_open, gap_extend).  Returns the dict of
    sam_cigar."""
    match, mismatch, go, ge = (int(x) for x in params)
    dev = reads.device
    tab = torch.as_tensor(_SW_TABLE, device=dev).long()
    n = read_id.shape[0]
    rid = read_id.long()
    m = read_len.long()[rid] if n else torch.zeros(0, dtype=torch.int64)
    mmax = int(m.max()) if n else 0
    q = tab[reads[rid, :mmax].long()] if n else \
        torch.zeros(0, 0, dtype=torch.int64)
    q = torch.where(torch.arange(mmax, device=dev)[None, :] < m[:, None],
                    q, 4)
    nw = wlen.long()
    wmax = win.shape[1]
    rcb = rc.bool()
    jj = torch.arange(wmax, device=dev)
    src = torch.where(rcb[:, None], nw[:, None] - 1 - jj[None, :],
                      jj[None, :]).clamp(0, max(wmax - 1, 0))
    r = tab[torch.gather(win.long(), 1, src)] if wmax else \
        torch.zeros(n, 0, dtype=torch.int64)
    r = torch.where(rcb[:, None] & (r < 4), r ^ 2, r)
    r = torch.where(jj[None, :] < nw[:, None], r, 4)
    sc, re, qe = forward_ends_plain(q, m, r, nw, match, mismatch, go, ge)
    qr, qr_len = _reversed_prefix(q, qe)
    rr, rr_len = _reversed_prefix(r, re)
    rr_len = torch.where(re >= 0, rr_len, 0)
    _, re2, rd2 = forward_ends_plain(qr, qr_len, rr, rr_len, match,
                                     mismatch, go, ge)
    ok2 = (re >= 0) & (re2 >= 0)
    re2 = torch.where(ok2, re2, 0)
    rd2 = torch.where(ok2, rd2, 0)
    rb = re - re2
    qb = qe - rd2
    has = m > 0
    sc = torch.where(has, sc, 0)
    re = torch.where(has, re, 0)
    qe = torch.where(has, qe, 0)
    rb = torch.where(has, rb, 0)
    qb = torch.where(has, qb, 0)
    cig = has & ~((score_filter != 0) & (sc < score_filter))
    clen = torch.full((n,), FILTERED, dtype=torch.int64, device=dev)
    sel = torch.nonzero(cig).flatten()
    cap_out = max(max_ops, 1)
    buf = torch.zeros(n, cap_out, dtype=torch.int64, device=dev)
    if len(sel):
        read_sub = qe[sel] - qb[sel] + 1
        ref_sub = re[sel] - rb[sel] + 1
        band = (ref_sub - read_sub).abs() + 1
        rb_c = rb[sel].clamp_min(0)
        ref_n = (re[sel] - rb_c + 1).clamp_min(0)
        lsub = int(read_sub.max())
        rsub = int(ref_n.max())
        ii = torch.arange(lsub, device=dev)
        rd = torch.gather(q[sel], 1, (qb[sel][:, None] + ii[None, :]).clamp(
            0, max(mmax - 1, 0))) if mmax else torch.zeros(
            len(sel), lsub, dtype=torch.int64, device=dev)
        rd = torch.where(ii[None, :] < read_sub[:, None], rd, 4)
        kk = torch.arange(rsub, device=dev)
        rf = torch.gather(r[sel], 1, (rb_c[:, None] + kk[None, :]).clamp(
            0, max(wmax - 1, 0))) if wmax and rsub else torch.zeros(
            len(sel), rsub, dtype=torch.int64, device=dev)
        rf = torch.where(kk[None, :] < ref_n[:, None], rf, 4)
        runs, nr, _ = banded_cigar_plain(rd, read_sub, rf, ref_n, sc[sel],
                                      band, (match, mismatch, go, ge),
                                      max_ops)
        clen[sel] = nr
        sc[sel] = torch.where(nr < 0, 0, sc[sel])
        # forward order for a forward hit; the traceback's own order (the
        # reversal undone) for rc
        width = runs.shape[1]
        k = torch.arange(width, device=dev)
        fwd = (nr[:, None] - 1 - k[None, :]).clamp(0, width - 1)
        src = torch.where(rcb[sel][:, None], k[None, :].expand_as(fwd), fwd)
        ordered = torch.gather(runs, 1, src)
        ordered = torch.where(k[None, :] < nr[:, None], ordered, 0)
        take = min(width, cap_out)
        buf[sel, :take] = ordered[:, :take]
    qlen = m
    rb_o = torch.where(rcb, nw - (re + 1), rb)
    re_o = torch.where(rcb, nw - (rb + 1), re)
    qb_o = torch.where(rcb, qlen - (qe + 1), qb)
    qe_o = torch.where(rcb, qlen - (qb + 1), qe)
    rs = ref_start.long()
    i32 = torch.int32
    return {"score": sc.to(i32), "ref_begin": (rb_o + rs).to(i32),
            "ref_end": (re_o + rs).to(i32), "query_begin": qb_o.to(i32),
            "query_end": qe_o.to(i32), "cigar_buf": buf.to(i32),
            "cigar_len": clen.to(i32)}


# --- sam_diff: plain version --------------------------------------------

class _Text:
    """Byte rows [n, cap] written at each row's own position; a row
    keeps counting past its cap (the length it needs)."""

    def __init__(self, n: int, cap: int, device):
        self.buf = torch.zeros(n, cap + 1, dtype=torch.uint8, device=device)
        self.cap = cap
        self.n = torch.zeros(n, dtype=torch.int64, device=device)

    def put(self, mask, byte) -> None:
        at = torch.where(mask & (self.n < self.cap), self.n, self.cap)
        val = byte if torch.is_tensor(byte) else torch.full_like(at, byte)
        self.buf.scatter_(1, at[:, None], val.to(torch.uint8)[:, None])
        self.n = self.n + mask.long()

    def num(self, mask, v) -> None:
        """str(v) of the rows in mask (v >= 0)."""
        if not bool(mask.any()):
            return
        v = torch.where(mask, v, 0)
        nd = torch.ones_like(v)
        p = torch.full_like(v, 10)
        for _ in range(18):
            nd = nd + (v >= p).long()
            p = p * 10
        for k in range(int(nd[mask].max())):
            digit = (v // 10 ** (nd - 1 - k).clamp_min(0)) % 10
            self.put(mask & (k < nd), digit + 48)

    def rows(self):
        return self.buf[:, :self.cap], self.n


class _Md:
    """The walk's MD components, merged as they come (SAM.h:192-217):
    numbers summed while they follow each other, `^` appending the next
    component as it is, a letter after a deletion preceded by "0"."""

    def __init__(self, n: int, cap: int, device):
        self.t = _Text(n, cap, device)
        z = torch.zeros(n, dtype=torch.bool, device=device)
        self.in_run, self.amb, self.consume, self.del_top = \
            z.clone(), z.clone(), z.clone(), z.clone()
        self.total = torch.zeros(n, dtype=torch.int64, device=device)
        self.top_mode = torch.zeros(n, dtype=torch.int64, device=device)
        self.top_val = torch.zeros(n, dtype=torch.int64, device=device)

    def flush(self, mask) -> None:
        f = mask & self.in_run
        self.t.num(f, self.total)
        self.amb = self.amb & ~f
        self.in_run = self.in_run & ~f

    def _add(self, mask, v) -> None:
        self.total = torch.where(mask & ~self.in_run, 0, self.total) + \
            torch.where(mask, v, 0)
        self.in_run = self.in_run | mask

    def number(self, mask, v) -> None:
        c = mask & self.consume
        self.t.num(c, v)
        self.consume = self.consume & ~c
        self.amb = self.amb | c
        self._add(mask & ~c, v)

    def letter(self, mask, ch) -> None:
        c = mask & self.consume
        self.t.put(c, ch)
        self.consume = self.consume & ~c
        self.amb = self.amb | c
        o = mask & ~c
        caret = o & (ch == 94)
        digit = o & (ch >= 48) & (ch <= 57)
        let = o & ~caret & ~digit
        self.flush(caret | let)
        self.t.put(caret, 94)
        self.consume = self.consume | caret
        self._add(digit, ch.long() - 48)
        self.t.put(let & self.amb, 48)
        self.amb = self.amb & ~let
        self.t.put(let, ch)

    def del_begin(self, mask) -> None:
        """The `^` component of a deletion; its bases follow as one
        component, appended as they are after the `^`.  After a consumed
        `^` (a `^` in the reference) the bases are a component of the
        top level: a number if they are digits, a `^` if they are one
        `^`, else letters."""
        c = mask & self.consume
        self.t.put(c, 94)
        self.consume = self.consume & ~c
        self.amb = self.amb | c
        self.del_top = torch.where(mask, c, self.del_top)
        self.top_mode = torch.where(mask, 0, self.top_mode)
        self.top_val = torch.where(mask, 0, self.top_val)
        o = mask & ~c
        self.flush(o)
        self.t.put(o, 94)

    def _letters(self, mask) -> None:
        self.flush(mask)
        self.t.put(mask & self.amb, 48)
        self.amb = self.amb & ~mask

    def del_char(self, mask, ch) -> None:
        raw = mask & ~self.del_top
        self.t.put(raw, ch)
        top = mask & self.del_top
        digit = (ch >= 48) & (ch <= 57)
        first = top & (self.top_mode == 0)
        # top_mode: 1 digits, 2 letters, 3 a `^` so far
        to_num = first & digit
        to_caret = first & (ch == 94)
        to_let = first & ~digit & (ch != 94)
        self.top_val = torch.where(
            top & (to_num | (self.top_mode == 1)) & digit,
            self.top_val * 10 + ch.long() - 48, self.top_val)
        self._letters(to_let)
        self.t.put(to_let, ch)
        again = top & (self.top_mode == 3)      # `^` then more: letters
        self._letters(again)
        self.t.put(again, 94)
        self.t.put(again, ch)
        self.t.put(top & (self.top_mode == 2), ch)
        self.top_mode = torch.where(to_num, 1, torch.where(
            to_caret, 3, torch.where(to_let | again, 2, self.top_mode)))

    def del_end(self, mask) -> None:
        self.amb = self.amb | (mask & ~self.del_top)
        top = mask & self.del_top
        self._add(top & (self.top_mode == 1), self.top_val)
        caret = top & (self.top_mode == 3)
        self.flush(caret)
        self.t.put(caret, 94)
        self.consume = self.consume | caret


def sam_diff_plain(reads, qual, read_len, qual_len, read_id, rc,
                   query_begin, query_end, cigar_buf, cigar_len, dwin, dlen,
                   match_tbl, mismatch_tbl,
                   cig_cap: int = TEXT_CAP, md_cap: int = TEXT_CAP):
    """The plain version of sam_diff, vectorised over alignments (a loop
    over the cigar's runs and their bases): reads / qual uint8 [n_reads,
    stride] ASCII, read_len and qual_len int32 [n_reads] (the query's and
    the quality string's lengths); per alignment read_id, rc, the
    overlap's query_begin and query_end, its cigar (cigar_buf rows of
    cigar_len runs, see NO_CIGAR), its reference window (dwin rows of
    dlen bytes from ref_begin, diff_windows); the walk's quality tables
    (float64 [100]).  Returns the dict of sam_diff."""
    dev = reads.device
    n = read_id.shape[0]
    rid = read_id.long()
    m = read_len.long()[rid]
    lq = qual_len.long()[rid]
    rcb = rc.bool()
    none = cigar_len.long() < -2
    nr = torch.where(cigar_len.long() >= 0, cigar_len.long(), 0)
    runs = cigar_buf.long()
    comp = torch.as_tensor(_RC_TABLE, device=dev)
    dl = dlen.long()
    stride = reads.shape[1]
    wd = dwin.shape[1]
    live = ~none
    cig = _Text(n, cig_cap, dev)
    md = _Md(n, md_cap, dev)
    nm = torch.zeros(n, dtype=torch.int64, device=dev)
    lp = torch.zeros(n, dtype=torch.float64, device=dev)
    ref_pos = torch.zeros(n, dtype=torch.int64, device=dev)
    qb = query_begin.long()
    q_pos = torch.where(live & (qb > 0), qb, 0)
    clip = live & (qb > 0)
    cig.num(clip, qb)
    cig.put(clip, 83)

    def ref_byte(pos):
        """The window's bytes at pos ([n] or [n, k]); NUL past dlen."""
        at = pos.clamp(0, max(wd - 1, 0))
        wide = at.dim() == 2
        at = at if wide else at[:, None]
        b = torch.gather(dwin, 1, at) if wd else \
            torch.zeros_like(at, dtype=torch.uint8)
        b = b if wide else b[:, 0]
        return torch.where(pos < (dl[:, None] if wide else dl), b, 0)

    def _row(t):
        return t[:, None] if t.dim() == 1 else t

    def query_byte(pos):
        pos = _row(pos)
        src = torch.where(rcb[:, None], m[:, None] - 1 - pos, pos).clamp(
            0, max(stride - 1, 0))
        b = torch.gather(reads[rid], 1, src)
        b = torch.where(rcb[:, None], comp[b.long()], b)
        return torch.where(pos < m[:, None], b, 0)

    def quality(pos):
        pos = _row(pos)
        src = torch.where(rcb[:, None], lq[:, None] - 1 - pos, pos).clamp(
            0, max(stride - 1, 0))
        v = (torch.gather(qual[rid], 1, src).long() - 33).clamp(0, 99)
        return torch.where(pos < lq[:, None], v, 1)

    for r in range(int(nr.max()) if n else 0):
        has = live & (r < nr)
        run = runs[:, min(r, runs.shape[1] - 1)]
        length = torch.where(has, run >> 4, 0)
        op = run & 15
        cig.num(has, length)
        cig.put(has, torch.where(op == 0, 77, torch.where(op == 1, 73, 68)))
        is_m, is_i, is_d = has & (op == 0), has & (op == 1), has & (op == 2)
        nm = nm + torch.where(is_i, length, 0)
        q_pos = q_pos + torch.where(is_i, length, 0)
        # an M run: its bases at once, then the walk's sum in base order
        # and its MD components mismatch by mismatch
        span = int(length[is_m].max()) if bool(is_m.any()) else 0
        k = torch.arange(span, device=dev)[None, :]
        inside = is_m[:, None] & (k < length[:, None])
        r_b = ref_byte(ref_pos[:, None] + k)
        q_at = q_pos[:, None] + k
        q_b = query_byte(q_at)
        q_v = quality(q_at)
        miss = inside & (r_b != q_b)
        add = torch.where(miss, mismatch_tbl[q_v], match_tbl[q_v])
        for j in range(span):
            lp = torch.where(inside[:, j], lp + add[:, j], lp)
        nm = nm + miss.sum(1)
        rank = torch.cumsum(miss.long(), 1)
        last = torch.full_like(nm, -1)
        for e in range(int(miss.sum(1).max()) if span else 0):
            at = torch.where(miss & (rank == e + 1), k, span).min(1).values
            hit = at < span
            gap = at - last - 1
            md.number(hit & (gap > 0), gap)
            md.letter(hit, torch.gather(r_b, 1, at.clamp(max=span - 1)[
                :, None])[:, 0])
            last = torch.where(hit, at, last)
        tail = length - last - 1
        md.number(is_m & (tail > 0), tail)
        ref_pos = ref_pos + torch.where(is_m, length, 0)
        q_pos = q_pos + torch.where(is_m, length, 0)
        # a D run, base by base
        md.del_begin(is_d)
        for j in range(int(length[is_d].max()) if bool(is_d.any())
                       else 0):
            bd = is_d & (j < length)
            md.del_char(bd, ref_byte(ref_pos))
            nm = nm + bd.long()
            ref_pos = ref_pos + bd.long()
        md.del_end(is_d)
    end_clip = m - query_end.long() - 1
    ec = live & (end_clip > 0)
    cig.num(ec, end_clip)
    cig.put(ec, 83)
    md.flush(live)
    cig_txt, cig_n = cig.rows()
    md_txt, md_n = md.t.rows()
    i32 = torch.int32
    return {"cigar_txt": cig_txt, "cigar_n": cig_n.to(i32),
            "md_txt": md_txt, "md_n": md_n.to(i32), "nm": nm.to(i32),
            "lp": lp, "ref_need": ref_pos.to(i32)}


# --- the launches -------------------------------------------------------

def _device_and_stream(t):
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"no SAM kernel for device {dev}")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def _check(name, t, dtype, dims, device, rows=None):
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous() or \
            t.device != device or (rows is not None and t.shape[0] != rows):
        raise ValueError(
            f"SAM operand {name}: {t.dtype} {tuple(t.shape)} on {t.device} "
            f"contiguous={t.is_contiguous()}, want {dtype} {dims}-d "
            f"contiguous on {device}"
            + ("" if rows is None else f" with {rows} rows"))


def _raise_on(err: int, name: str, n: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} ({n} "
                           f"alignments)")


def takes_group(stride: int, width: int, params) -> bool:
    """Whether sam_cigar's group kernel takes reads of this stride and
    windows of this width: the packed key holds rows and columns up to
    1024 and scores up to 2047, and the wavefront's F equals the
    native's for gap_open >= gap_extend.  Else sam_cigar_long."""
    match, _, go, ge = (int(x) for x in params)
    return max(stride, 1) <= 1024 and width <= 1024 and \
        match * max(stride, 1) <= 2047 and go >= ge


def band_ints(w_cap: int) -> int:
    """Ints of one band row (three an alignment)."""
    return max(2 * w_cap + 5, 8)


def band_region(qmax: int, w_cap: int) -> int:
    """Bytes of one alignment's band region: three band rows, then the
    direction bytes of reads up to qmax bases at half-widths up to w_cap,
    rounded up to 16."""
    return -(-(12 * band_ints(w_cap) + qmax * (2 * w_cap + 1)) // 16) * 16


class CigarConfig(NamedTuple):
    group: int        # G lanes an alignment (a power of two <= 32)
    rows: int         # R query rows a lane
    threads: int      # threads a block
    blocks: int       # grid size
    col_stride: int   # score words an alignment's window
    smem: int         # dynamic shared memory a block, bytes


def cigar_config(n: int, stride: int, width: int) -> CigarConfig:
    """The passes kernel's launch for n alignments of reads of `stride`
    bytes and windows of `width` bases: G, R and the score words'
    stride as sw_align takes them for Lq = stride, Lr = width
    (sw_cuda.launch_config), GROUP_THREADS a block, cut until the block's
    shared memory (score words, extents, the code table) fits.  The band
    kernel's launch (8 lanes an alignment, its region band_region(stride,
    W_CAP)) is the library's own."""
    sw = launch_config(max(n, 1), max(stride, 1), max(width, 1))
    threads = GROUP_THREADS

    def smem(t):
        return -(-((t // sw.group) * (sw.stride + 2) * 4 + 256) // 16) * 16
    while threads > max(sw.group, 32) and smem(threads) > SMEM_BLOCK_LIMIT:
        threads //= 2
    return CigarConfig(sw.group, sw.rows, threads,
                       -(-n // (threads // sw.group)), sw.stride,
                       smem(threads))


def long_threads(qmax: int) -> int:
    """Threads a sam_cigar_long block: at most LONG_THREADS, as many as
    LONG_SMEM_TARGET bytes of shared memory hold at 9 bytes a query
    row."""
    return max(1, min(LONG_THREADS, LONG_SMEM_TARGET // (9 * max(qmax, 1))))


def relaunch_width(qmax: int) -> int:
    """The band half-width of sam_cigar's relaunch: any band reads of at
    most qmax bases allow (it starts at most at qmax + 1 and doubles at
    most once past qmax - 1)."""
    return 2 * qmax + 2


def _at(t, lo):
    return t.data_ptr() + lo * t.stride(0) * t.element_size()


_CIGAR_OUT = ("score", "ref_begin", "ref_end", "query_begin", "query_end",
              "cigar_buf", "cigar_len")


def _cigar_launch(reads, read_len, tab, win, wlen, read_id, rc, ref_start,
                  params, score_filter, max_ops, out, w_cap, ops_cap,
                  batch: int) -> None:
    """sam_cigar launches over out's rows in batches: the passes, then the
    band kernel with its regions in shared memory; out: the output
    tensors (cigar_buf [n, ops_cap])."""
    index, stream = _device_and_stream(reads)
    lib = load_library()
    n = read_id.shape[0]
    stride, width = reads.shape[1], win.shape[1]
    match, mismatch, go, ge = (int(x) for x in params)
    cfg = cigar_config(min(batch, n), stride, width)
    for lo in range(0, n, batch):
        cnt = min(batch, n - lo)
        err = lib.kslam_sam_cigar(
            reads.data_ptr(), read_len.data_ptr(), reads.stride(0),
            tab.data_ptr(), _at(win, lo), _at(wlen, lo), win.stride(0),
            width, _at(read_id, lo), _at(rc, lo), _at(ref_start, lo), cnt,
            match, mismatch, go, ge, int(score_filter), int(max_ops),
            *(_at(out[k], lo) for k in _CIGAR_OUT), ops_cap, w_cap,
            cfg.group, cfg.rows, cfg.col_stride, cfg.threads, cfg.smem,
            index, stream)
        _raise_on(err, "sam_cigar", cnt)
        SAM_LAUNCHES["sam_cigar"] += 1
        SAM_LAUNCHES["sam_band"] += 1


def _band_launch(reads, read_len, tab, win, wlen, read_id, rc, ref_start,
                 params, score_filter, max_ops, out, runs, rows, w_cap,
                 skip_w: int, batch: int):
    """sam_cigar's band kernel alone on out's rows `rows` (int64), whose
    score and ends hold their passes and whose cigar_len the REDO codes of
    the first launch (a REDO row skips the attempts up to skip_w, which
    failed there), half-widths up to w_cap: in batches, the regions in a
    device slab for one batch (reused), row t's runs in runs[t] (zero past
    them) and, when they fit, in out's cigar_buf.  Returns the rows left
    flagged and the most runs of a row, as a device int32 [2]."""
    index, stream = _device_and_stream(reads)
    lib = load_library()
    stride, width = reads.shape[1], win.shape[1]
    match, mismatch, go, ge = (int(x) for x in params)
    stats = torch.zeros(2, dtype=torch.int32, device=reads.device)
    n = rows.shape[0]
    slab = torch.empty(min(batch, n) * band_region(stride, w_cap),
                       dtype=torch.uint8, device=reads.device)
    for lo in range(0, n, batch):
        cnt = min(batch, n - lo)
        err = lib.kslam_sam_band(
            reads.data_ptr(), read_len.data_ptr(), reads.stride(0),
            tab.data_ptr(), win.data_ptr(), wlen.data_ptr(), win.stride(0),
            width, read_id.data_ptr(), rc.data_ptr(), ref_start.data_ptr(),
            cnt, match, mismatch, go, ge, int(score_filter), int(max_ops),
            *(out[k].data_ptr() for k in _CIGAR_OUT[:5]), _at(runs, lo),
            out["cigar_len"].data_ptr(), runs.shape[1], slab.data_ptr(),
            w_cap, skip_w, _at(rows, lo), out["cigar_buf"].data_ptr(),
            out["cigar_buf"].shape[1], stats.data_ptr(), index, stream)
        _raise_on(err, "sam_band", cnt)
        SAM_LAUNCHES["sam_band"] += 1
    return stats


def _cigar_long_launch(reads, read_len, tab, win, wlen, read_id, rc,
                       ref_start, params, score_filter, max_ops, out, w_cap,
                       ops_cap, batch: int) -> None:
    """sam_cigar_long launches over out's rows in batches (device slabs
    for one batch, reused)."""
    index, stream = _device_and_stream(reads)
    lib = load_library()
    n = read_id.shape[0]
    qmax = reads.shape[1]
    threads = long_threads(qmax)
    rows = min(batch, n)
    dev = reads.device
    dir_slab = torch.empty(rows * qmax * (2 * w_cap + 1), dtype=torch.uint8,
                           device=dev)
    band_rows = torch.empty(rows * 3 * band_ints(w_cap), dtype=torch.int32,
                            device=dev)
    match, mismatch, go, ge = (int(x) for x in params)
    for lo in range(0, n, batch):
        cnt = min(batch, n - lo)
        err = lib.kslam_sam_cigar_long(
            reads.data_ptr(), read_len.data_ptr(), reads.stride(0),
            tab.data_ptr(), _at(win, lo), _at(wlen, lo), win.stride(0),
            _at(read_id, lo), _at(rc, lo), _at(ref_start, lo), cnt, match,
            mismatch, go, ge, int(score_filter), int(max_ops),
            *(_at(out[k], lo) for k in _CIGAR_OUT), ops_cap,
            dir_slab.data_ptr(), band_rows.data_ptr(), w_cap, qmax,
            threads, index, stream)
        _raise_on(err, "sam_cigar_long", cnt)
        SAM_LAUNCHES["sam_cigar_long"] += 1


def _cigar_outputs(n: int, ops_cap: int, dev):
    out = {k: torch.empty(n, dtype=torch.int32, device=dev)
           for k in ("score", "ref_begin", "ref_end", "query_begin",
                     "query_end", "cigar_len")}
    out["cigar_buf"] = torch.zeros(n, ops_cap, dtype=torch.int32, device=dev)
    return out


def check_cigar_operands(reads, read_len, read_id, rc, win, wlen,
                         ref_start) -> None:
    """Raises ValueError unless the operands are contiguous, of the
    kernel's types, on reads' device, with one row an alignment."""
    dev = reads.device
    n = read_id.shape[0]
    _check("reads", reads, torch.uint8, 2, dev)
    _check("read_len", read_len, torch.int32, 1, dev, reads.shape[0])
    _check("read_id", read_id, torch.int32, 1, dev)
    _check("rc", rc, torch.uint8, 1, dev, n)
    _check("win", win, torch.uint8, 2, dev, n)
    _check("wlen", wlen, torch.int32, 1, dev, n)
    _check("ref_start", ref_start, torch.int32, 1, dev, n)


def sam_cigar(reads, read_len, read_id, rc, win, wlen, ref_start, params,
              score_filter: int = 0, max_ops: int = 0):
    """The cigar columns of kslam_ssw_cigar_batch (report_cigar on) for
    every alignment: reads uint8 [n_reads, stride] ASCII, read_len int32;
    per alignment read_id int32, rc uint8, its native window win uint8
    [n, W] of wlen (int32) bases (native_windows) and ref_start int32;
    params (match, mismatch, gap_open, gap_extend); max_ops the native
    call's (native_max_ops).  Returns {score, ref_begin, ref_end,
    query_begin, query_end, cigar_len: int32 [n], cigar_buf: int32 [n,
    C]}, C >= every row's runs.  CPU tensors: the plain version; CUDA
    tensors: the passes kernel and the band kernel (sam_cigar_long past
    takes_group), in batches of BATCH, then the band kernel again on the
    rows it flagged, with their regions in a device slab; never the plain
    version."""
    if reads.device.type == "cpu":
        return sam_cigar_plain(reads, read_len, read_id, rc, win, wlen,
                               ref_start, params, score_filter, max_ops)
    check_cigar_operands(reads, read_len, read_id, rc, win, wlen, ref_start)
    dev = reads.device
    n = read_id.shape[0]
    tab = sw_table(dev)
    out = _cigar_outputs(n, OPS_CAP, dev)
    if n == 0:
        return out
    qmax = reads.shape[1]
    group = takes_group(qmax, win.shape[1], params)
    operands = (reads, read_len, tab, win, wlen, read_id, rc, ref_start,
                params, score_filter, max_ops)
    if group:
        _cigar_launch(*operands, out, W_CAP, OPS_CAP, BATCH)
    else:
        _cigar_long_launch(*operands, out, W_CAP, OPS_CAP, BATCH)
    # REDO and REDO_OPS are the codes under REDO (NO_CIGAR is sam_diff's)
    redo = torch.nonzero(out["cigar_len"] <= REDO).flatten()
    if redo.numel() == 0:
        return out
    w_big = relaunch_width(qmax)
    ops_big = max(max_ops, 1)
    batch = max(1, (256 << 20) // band_region(qmax, w_big))
    if group:
        # any band their lengths allow (the attempts up to W_CAP skipped),
        # in a device slab; runs that fit OPS_CAP land in out's cigar_buf
        # at once
        runs = torch.empty(redo.numel(), ops_big, dtype=torch.int32,
                           device=dev)
        still, longest = _band_launch(*operands, out, runs, redo, w_big,
                                      W_CAP, batch).tolist()
    else:
        # the long path computes the rows again, on their own operands
        sub = _cigar_outputs(redo.numel(), ops_big, dev)
        _cigar_long_launch(reads, read_len, tab, *(
            t[redo].contiguous() for t in (win, wlen, read_id, rc,
                                           ref_start)), params, score_filter,
            max_ops, sub, w_big, ops_big, batch)
        runs = sub.pop("cigar_buf")
        for k, v in sub.items():
            out[k][redo] = v
        still, longest = torch.stack([(sub["cigar_len"] <= REDO).sum(),
                                      sub["cigar_len"].max().long()]
                                     ).tolist()
    if still:
        raise RuntimeError(f"sam_cigar: {still} alignments outgrew the "
                           f"relaunch's band {w_big} or its {ops_big} runs")
    if longest <= OPS_CAP and group:
        return out
    width = max(OPS_CAP, longest)
    if width > OPS_CAP:
        wide = torch.zeros(n, width, dtype=torch.int32, device=dev)
        wide[:, :OPS_CAP] = out["cigar_buf"]
        out["cigar_buf"] = wide
    out["cigar_buf"][redo] = runs[:, :width] if runs.shape[1] >= width else \
        torch.nn.functional.pad(runs, (0, width - runs.shape[1]))
    return out


def check_diff_operands(reads, qual, read_len, qual_len, read_id, rc,
                        query_begin, query_end, cigar_buf, cigar_len, dwin,
                        dlen, match_tbl, mismatch_tbl) -> None:
    """Raises ValueError unless the operands are contiguous, of the
    kernel's types, on reads' device, with one row an alignment."""
    dev = reads.device
    n = read_id.shape[0]
    _check("reads", reads, torch.uint8, 2, dev)
    _check("qual", qual, torch.uint8, 2, dev, reads.shape[0])
    if qual.shape != reads.shape:
        raise ValueError(f"SAM operand qual {tuple(qual.shape)} is not "
                         f"shaped like reads {tuple(reads.shape)}")
    _check("read_len", read_len, torch.int32, 1, dev, reads.shape[0])
    _check("qual_len", qual_len, torch.int32, 1, dev, reads.shape[0])
    _check("read_id", read_id, torch.int32, 1, dev)
    for name, t in (("query_begin", query_begin), ("query_end", query_end),
                    ("cigar_len", cigar_len), ("dlen", dlen)):
        _check(name, t, torch.int32, 1, dev, n)
    _check("rc", rc, torch.uint8, 1, dev, n)
    _check("cigar_buf", cigar_buf, torch.int32, 2, dev, n)
    _check("dwin", dwin, torch.uint8, 2, dev, n)
    _check("match_tbl", match_tbl, torch.float64, 1, dev, 100)
    _check("mismatch_tbl", mismatch_tbl, torch.float64, 1, dev, 100)


def sam_diff(reads, qual, read_len, qual_len, read_id, rc, query_begin,
             query_end, cigar_buf, cigar_len, dwin, dlen, match_tbl,
             mismatch_tbl, cig_cap: int = TEXT_CAP, md_cap: int = TEXT_CAP):
    """get_cigar_and_md of every alignment (see sam_diff_plain for the
    operands).  Returns {cigar_txt uint8 [n, cig_cap], cigar_n, md_txt
    uint8 [n, md_cap], md_n, nm, ref_need: int32 [n], lp: float64 [n]}:
    a row's texts are its first cigar_n / md_n bytes when those fit the
    caps, and ref_need is the reference bases its walk read from the
    window (more than dlen where the entry goes on: a wider window is
    needed).  CPU tensors: the plain version; CUDA tensors: the kernel,
    in batches of BATCH, never the plain version."""
    if reads.device.type == "cpu":
        return sam_diff_plain(reads, qual, read_len, qual_len, read_id, rc,
                              query_begin, query_end, cigar_buf, cigar_len,
                              dwin, dlen, match_tbl, mismatch_tbl,
                              cig_cap, md_cap)
    check_diff_operands(reads, qual, read_len, qual_len, read_id, rc,
                        query_begin, query_end, cigar_buf, cigar_len, dwin,
                        dlen, match_tbl, mismatch_tbl)
    index, stream = _device_and_stream(reads)
    dev = reads.device
    n = read_id.shape[0]
    out = {"cigar_txt": torch.zeros(n, cig_cap, dtype=torch.uint8,
                                    device=dev),
           "md_txt": torch.zeros(n, md_cap, dtype=torch.uint8, device=dev),
           "lp": torch.empty(n, dtype=torch.float64, device=dev)}
    for k in ("cigar_n", "md_n", "nm", "ref_need"):
        out[k] = torch.empty(n, dtype=torch.int32, device=dev)
    comp = rc_table(dev)
    lib = load_library()
    for lo in range(0, n, BATCH):
        cnt = min(BATCH, n - lo)
        err = lib.kslam_sam_diff(
            reads.data_ptr(), qual.data_ptr(), read_len.data_ptr(),
            qual_len.data_ptr(), reads.stride(0), comp.data_ptr(),
            _at(read_id, lo), _at(rc, lo), _at(query_begin, lo),
            _at(query_end, lo), _at(cigar_buf, lo), cigar_buf.stride(0),
            _at(cigar_len, lo), _at(dwin, lo), dwin.stride(0), _at(dlen, lo),
            match_tbl.data_ptr(), mismatch_tbl.data_ptr(), cnt,
            _at(out["cigar_txt"], lo), cig_cap, _at(out["cigar_n"], lo),
            _at(out["md_txt"], lo), md_cap, _at(out["md_n"], lo),
            _at(out["nm"], lo), _at(out["lp"], lo), _at(out["ref_need"], lo),
            index, stream)
        _raise_on(err, "sam_diff", cnt)
        SAM_LAUNCHES["sam_diff"] += 1
    return out
