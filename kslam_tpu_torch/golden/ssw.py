"""Exact scalar (NumPy) emulation of the reference's striped Smith-Waterman.

This is the *golden model* every device kernel is tested against.  It
reproduces the observable behavior of ssw.c/ssw_cpp.cpp as used by the
reference pipeline (SmithWaterman.h:184-233):

* local affine-gap SW score, gap cost = gap_open + (L-1) * gap_extend,
  N (code 4) scores 0 against everything (ssw_cpp.cpp:25-49),
* end position tie-breaks: the reported ref end is the FIRST reference
  column whose column-max strictly improves on the running maximum
  (ssw.c:316-324 / 536-540); the read end is the SMALLEST query index whose
  cell in that column equals the maximum (ssw.c:333-342 / 548-557),
* begin position found by re-aligning the reversed read prefix against the
  reversed ref prefix with the same rules (ssw.c:905-923),
* cigar from a scalar banded DP over the [begin, end] window with band
  doubling and the reference's direction-preference rules (ssw.c:594-792),
  including its quirks (the i==0 row is never traced and contributes a
  merged/extra leading M, ssw.c:754-771).

Scores are computed in int32; the byte->word escalation of the SSE kernel
(ssw.c:870-877) is score-exact and therefore needs no emulation, except
that a score-0 result reports ref_end = -1 like the byte kernel
(ssw.c:169).

Caveat (documented, asserted): ssw's lazy-F loop does not refresh E after
F corrections, disallowing insertion-adjacent-to-deletion paths.  With the
pipeline's penalty regime (2*gap_open > match + mismatch, e.g. the defaults
2/3/5/2) such paths are never optimal, so classic Gotoh H values are
identical.  `check_params` rejects configurations where this could differ.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import SWParams


def check_params(p: SWParams) -> None:
    if not (2 * p.gap_open > p.match + p.mismatch and p.gap_open >= p.gap_extend >= 1):
        raise ValueError(
            "SW params admit insertion-adjacent-to-deletion optima; "
            "golden model would diverge from the striped reference kernel: %r" % (p,)
        )


@dataclasses.dataclass
class Alignment:
    """Mirror of StripedSmithWaterman::Alignment (ssw_cpp.h:10-87)."""
    sw_score: int = 0
    ref_begin: int = 0
    ref_end: int = 0
    query_begin: int = 0
    query_end: int = 0
    # list of (length, op) with op in "MID"; None when cigar not requested
    cigar: list | None = None

    def cigar_string(self) -> str:
        if not self.cigar:
            return ""
        return "".join(f"{l}{op}" for l, op in self.cigar)


def _score_matrix(p: SWParams) -> np.ndarray:
    """5x5 matrix in our code space (A0 C1 T2 G3 N4); N row/col = 0."""
    m = np.full((5, 5), -int(p.mismatch), dtype=np.int32)
    np.fill_diagonal(m, int(p.match))
    m[4, :] = 0
    m[:, 4] = 0
    return m


def sw_forward_ends(query: np.ndarray, ref: np.ndarray, p: SWParams):
    """Forward pass: returns (score, ref_end, read_end) with ssw tie-breaks.

    query/ref: uint8 code-5 arrays.  ref_end == -1 when score == 0.
    """
    m = int(len(query))
    n = int(len(ref))
    if m == 0 or n == 0:
        # no columns processed: ref_end stays -1 (byte kernel init,
        # ssw.c:169) and the pvHmax trace over the all-zero buffer reports
        # the smallest striped index, i.e. read position 0 (ssw.c:333-342)
        return 0, -1, 0
    mat = _score_matrix(p)
    go, ge = int(p.gap_open), int(p.gap_extend)
    q = np.asarray(query, dtype=np.int64)
    idx = np.arange(m, dtype=np.int64)

    h_prev = np.zeros(m, dtype=np.int64)
    e_prev = np.zeros(m, dtype=np.int64)  # clamped at 0 like subs_epu
    best = 0
    best_col = -1
    saved_col = None
    neg = np.int64(-(1 << 40))
    for j in range(n):
        s = mat[q, int(ref[j])]
        diag = np.empty(m, dtype=np.int64)
        diag[0] = 0
        diag[1:] = h_prev[:-1]
        h = np.maximum(diag + s, 0)
        h = np.maximum(h, e_prev)
        # F via prefix-max, iterated to fixpoint (one pass suffices for
        # gap_open >= gap_extend; iterate for safety)
        while True:
            a = h - go + idx * ge
            pref = np.empty(m, dtype=np.int64)
            pref[0] = neg
            if m > 1:
                np.maximum.accumulate(a[:-1], out=pref[1:])
            f = pref - (idx - 1) * ge
            h_new = np.maximum(h, f)
            if np.array_equal(h_new, h):
                break
            h = h_new
        e_prev = np.maximum(np.maximum(h - go, e_prev - ge), 0)
        colmax = int(h.max())
        if colmax > best:
            best = colmax
            best_col = j
            saved_col = h.copy()
        h_prev = h
    if best == 0:
        # max never strictly improved, pvHmax stays all-zero: every striped
        # cell "equals" the max and the min index wins (ssw.c:333-342)
        return 0, -1, 0
    read_end = int(np.flatnonzero(saved_col == best)[0])
    return best, best_col, read_end


def banded_cigar(read: np.ndarray, ref: np.ndarray, score: int, p: SWParams,
                 band_width: int) -> list | None:
    """Banded DP + traceback emulating ssw.c:594-792 exactly.

    read/ref are the [begin..end] sub-sequences.  Returns list of
    (length, op) with op in "MID" (query-consuming order, forward), or
    None on the reference's overflow-abort path.
    """
    mat = _score_matrix(p)
    go, ge = int(p.gap_open), int(p.gap_extend)
    read_len = int(len(read))
    ref_len = int(len(ref))
    rd = np.asarray(read, dtype=np.int64)
    rf = np.asarray(ref, dtype=np.int64)

    def u_of(w, i, j):
        x = max(i - w, 0)
        return j - x + 1

    while True:
        w = band_width
        width = w * 2 + 3
        width_d = w * 2 + 1
        if width_d * read_len * 3 >= (1 << 31):
            return None  # ssw.c:631-642 abort
        h_b = np.zeros(max(width + 2, 8), dtype=np.int64)
        e_b = np.zeros_like(h_b)
        h_c = np.zeros_like(h_b)
        direction = np.zeros((read_len, width_d * 3), dtype=np.int8)
        max_score = 0
        u = 0
        for i in range(read_len):
            beg = max(0, i - w)
            end = min(ref_len - 1, i + w)
            edge = min(end + 1, width - 1)
            f = 0
            h_b[0] = e_b[0] = h_b[edge] = e_b[edge] = h_c[0] = 0
            dline = direction[i]
            x_i = max(i - w, 0)
            for j in range(beg, end + 1):
                u = u_of(w, i, j)
                e_idx = u_of(w, i - 1, j)
                b = u_of(w, i, j - 1)
                d = u_of(w, i - 1, j - 1)
                dbase = (j - x_i) * 3
                t1 = -go if i == 0 else int(h_b[e_idx]) - go
                t2 = -ge if i == 0 else int(e_b[e_idx]) - ge
                e_new = max(t1, t2)
                dline[dbase + 0] = 3 if t1 > t2 else 2
                t1 = int(h_c[b]) - go
                t2 = f - ge
                f = max(t1, t2)
                dline[dbase + 1] = 5 if t1 > t2 else 4
                e1 = max(e_new, 0)
                f1 = max(f, 0)
                t1 = max(e1, f1)
                t2 = int(h_b[d]) + int(mat[rd[i], rf[j]])
                e_b[u] = e_new
                h_c[u] = max(t1, t2)
                if h_c[u] > max_score:
                    max_score = int(h_c[u])
                if t1 <= t2:
                    dline[dbase + 2] = 1
                else:
                    dline[dbase + 2] = dline[dbase + 0] if e1 > f1 else dline[dbase + 1]
            h_b[1:u + 1] = h_c[1:u + 1]
        if max_score >= score:
            break
        band_width *= 2

    # traceback (ssw.c:697-785)
    ops = []  # runs appended in traceback (reverse) order: (count, opcode)
    i = read_len - 1
    j = ref_len - 1
    e = 0
    f = 0      # current op: 0 M, 1 I, 2 D
    run_op = 0
    temp2 = 2  # which direction layer to read: 0 e, 1 f, 2 h
    row = read_len - 1
    while i > 0:
        x = max(i - band_width, 0)
        d = int(direction[row][(j - x) * 3 + temp2])
        if d == 1:
            i -= 1
            j -= 1
            temp2 = 2
            row -= 1
            f = 0
        elif d == 2:
            i -= 1
            temp2 = 0
            row -= 1
            f = 1
        elif d == 3:
            i -= 1
            temp2 = 2
            row -= 1
            f = 1
        elif d == 4:
            j -= 1
            temp2 = 1
            f = 2
        elif d == 5:
            j -= 1
            temp2 = 2
            f = 2
        else:
            raise RuntimeError("trace back error")
        if f == run_op:
            e += 1
        else:
            ops.append((e, run_op))
            run_op = f
            e = 1
    if f == 0:
        ops.append((e + 1, 0))
    else:
        ops.append((e, f))
        ops.append((1, 0))
    ops.reverse()
    return [(l, "MID"[op]) for l, op in ops]


def ssw_align(query: np.ndarray, ref: np.ndarray, p: SWParams,
              report_cigar: bool = False, score_filter: int = 0) -> Alignment:
    """Full emulation of Aligner::Align as invoked by the pipeline
    (SmithWaterman.h:191-211): report_begin_position always on,
    score_filter = scoreThreshold, distance filter unset."""
    al = Alignment()
    m = int(len(query))
    n = int(len(ref))
    if m == 0:
        return al
    score, ref_end, read_end = sw_forward_ends(query, ref, p)
    al.sw_score = score
    al.ref_end = ref_end
    al.query_end = read_end
    # reverse pass (ssw.c:905-923): reversed read prefix vs reversed ref prefix
    q_r = np.ascontiguousarray(query[read_end::-1])
    r_r = np.ascontiguousarray(ref[ref_end::-1]) if ref_end >= 0 else query[:0]
    _, re2, rd2 = sw_forward_ends(q_r, r_r, p)
    if len(r_r) == 0:
        re2, rd2 = 0, 0
    else:
        if re2 < 0:  # cannot happen when score > 0; defensive
            re2, rd2 = 0, 0
    al.ref_begin = ref_end - re2
    al.query_begin = read_end - rd2
    if report_cigar and not (score_filter and score < score_filter):
        ref_sub_len = al.ref_end - al.ref_begin + 1
        read_sub_len = al.query_end - al.query_begin + 1
        band = abs(ref_sub_len - read_sub_len) + 1
        cigar = banded_cigar(
            np.asarray(query[al.query_begin:al.query_end + 1]),
            np.asarray(ref[al.ref_begin:al.ref_end + 1]),
            score, p, band)
        if cigar is None:
            al.cigar = None
            al.sw_score = 0  # ssw.c:941-944
        else:
            al.cigar = cigar
    return al


def slam_overlap_align(read_codes: np.ndarray, entry_codes: np.ndarray,
                       relative_position: int, rev_comp: bool, p: SWParams,
                       report_cigar: bool = False,
                       score_filter: int = 0) -> Alignment:
    """Emulates performSmithWatermanOnRange2 (SmithWaterman.h:184-233) for a
    single overlap: slice the ref window at max(rel,0) of query length,
    reverse-complement the *window* for RC overlaps, align, then flip
    coordinates back to forward-ref space and reverse the cigar."""
    qlen = int(len(read_codes))
    ref_start = max(int(relative_position), 0)
    window = entry_codes[ref_start:ref_start + qlen]
    if rev_comp:
        window = np.where(window < 4, window ^ 2, window)[::-1]
    window = np.ascontiguousarray(window)
    al = ssw_align(read_codes, window, p, report_cigar, score_filter)
    if rev_comp:
        if al.cigar is not None:
            al.cigar = al.cigar[::-1]
        rlen = len(window)
        al.ref_begin, al.ref_end = rlen - (al.ref_end + 1), rlen - (al.ref_begin + 1)
        al.query_begin, al.query_end = qlen - (al.query_end + 1), qlen - (al.query_begin + 1)
    al.ref_begin += ref_start
    al.ref_end += ref_start
    return al
