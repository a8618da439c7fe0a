"""SAM lines of the sampled reads by the plain reference: position,
flags, CIGAR, MD and NM of every line the port writes for them.

The CIGAR is a frozen copy of kslam_tpu_torch's golden/ssw.py banded
traceback (ssw.c:594-792), run on each written overlap's own window
(performSmithWatermanOnRange2, SmithWaterman.h:184-233) over the span
the reference's own alignment of it (reference/sw.py) gives; MD and NM are a copy of io/sam.py's
get_cigar_and_md walk (SAM.h:101-237) without the quality model; flags
and positions follow getSAMFromPair and writeSAMOutputPairs
(SAM.h:352-512): a read's pairs by combined score, highest first, the
first num_sam_alignments, the first pair primary.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SWParams(NamedTuple):
    match: int
    mismatch: int
    gap_open: int
    gap_extend: int


def _score_matrix(p: SWParams) -> np.ndarray:
    """5x5 matrix in our code space (A0 C1 T2 G3 N4); N row/col = 0."""
    m = np.full((5, 5), -int(p.mismatch), dtype=np.int32)
    np.fill_diagonal(m, int(p.match))
    m[4, :] = 0
    m[:, 4] = 0
    return m


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


def overlap_cigar(read_codes, entry_codes, rel: int, rc: bool, score: int,
                  ref_begin: int, ref_end: int, query_begin: int,
                  query_end: int, p):
    """The CIGAR (forward order) of an overlap aligned on its own window
    (performSmithWatermanOnRange2, SmithWaterman.h:184-233: the window
    at max(rel, 0) of the read's length, reverse-complemented for RC),
    from its alignment in forward coordinates: the banded traceback of
    ssw_align over the aligned parts, in window coordinates."""
    qlen = int(len(read_codes))
    start = max(int(rel), 0)
    window = entry_codes[start:start + qlen]
    wlen = len(window)
    rb, re = ref_begin - start, ref_end - start
    if rc:
        window = np.where(window < 4, window ^ 2, window)[::-1]
        rb, re = wlen - 1 - re, wlen - 1 - rb
        query_begin, query_end = qlen - 1 - query_end, qlen - 1 - query_begin
    cigar = banded_cigar(np.asarray(read_codes[query_begin:query_end + 1]),
                         np.ascontiguousarray(window[rb:re + 1]), score, p,
                         abs((re - rb) - (query_end - query_begin)) + 1)
    return cigar[::-1] if rc and cigar is not None else cigar


COMP = bytes.maketrans(b"ACGTacgtNn", b"TGCAtgcaNn")


def cigar_md_nm(cigar, rc: bool, query_begin: int, query_end: int,
                ref_begin: int, read: bytes, ref: np.ndarray):
    """(CIGAR text with soft clips, MD, NM) of an overlap (SAM.h:101-237):
    read is the read's ASCII bases, ref the entry's ASCII bases."""
    if cigar is None:
        return "", "", 0
    query = read.translate(COMP)[::-1] if rc else read
    out, md, nm = "", [], 0
    ref_pos, query_pos = ref_begin, 0
    if query_begin > 0:
        out += f"{query_begin}S"
        query_pos += query_begin
    for length, op in cigar:
        out += f"{length}{op}"
        if op == "M":
            run = 0
            for _ in range(length):
                r = chr(ref[ref_pos]) if ref_pos < len(ref) else "\0"
                q = chr(query[query_pos]) if query_pos < len(query) else "\0"
                if r == q:
                    run += 1
                else:
                    nm += 1
                    if run:
                        md.append(str(run))
                    md.append(r)
                    run = 0
                ref_pos += 1
                query_pos += 1
            if run:
                md.append(str(run))
        elif op == "I":
            nm += length
            query_pos += length
        elif op == "D":
            md.append("^")
            md.append("".join(chr(ref[ref_pos + k]) if ref_pos + k < len(ref)
                              else "\0" for k in range(length)))
            nm += length
            ref_pos += length
    end_clip = len(query) - query_end - 1
    if end_clip > 0:
        out += f"{end_clip}S"
    text, ambiguous, i = "", False, 0
    while i < len(md):
        comp = md[i]
        if comp == "^":
            text += comp + md[i + 1]
            ambiguous = True
            i += 2
        elif comp and comp[0].isdigit():
            total = 0
            while i < len(md) and md[i][0].isdigit():
                total += int(md[i])
                i += 1
            text += str(total)
            ambiguous = False
        else:
            if ambiguous:
                text += "0"
                ambiguous = False
            text += comp
            i += 1
    return out, text, nm


def read_lines(pairs, overlaps, reads, entries, sw, num_alignments: int):
    """[(flag, pos, cigar, md, nm)] of the lines written for one read.
    pairs: the read's surviving pairs in the pipeline's order, each
    (r1 overlap row or -1, r2 overlap row or -1, combined score u32);
    overlaps: row -> (read row, entry, rel_pos, rc, score, ref_begin,
    ref_end, query_begin, query_end), the reference's own alignment;
    reads: read row -> ASCII bytes; entries: entry -> (ASCII u8 array,
    SW codes u8 array); sw: SWParams."""
    top = sorted(pairs, key=lambda p: -p[2])[:num_alignments]
    out = []
    for k, (i1, i2, _) in enumerate(top):
        segs = []
        for i in (i1, i2):
            if i < 0:
                segs.append(None)
                continue
            row, entry, rel, rc, score, ref_begin, ref_end, qb, qe = \
                overlaps[i]
            read = reads[row]
            codes = SW_LUT[np.frombuffer(read, np.uint8)]
            cigar = overlap_cigar(codes, entries[entry][1], rel, rc, score,
                                  ref_begin, ref_end, qb, qe, sw)
            cig, md, nm = cigar_md_nm(cigar, rc, qb, qe, ref_begin, read,
                                      entries[entry][0])
            segs.append((rc, ref_begin + 1, cig, md, nm))
        a, b = segs
        base = 0x1 | (0x100 if k else 0)
        if a and b:
            base |= 0x2
        f1 = base | 0x40 | (0x10 if a and a[0] else 0) | \
            (0x20 if a and b and b[0] else 0) | (0x8 if b is None else 0)
        f2 = base | 0x80 | (0x10 if b and b[0] else 0) | \
            (0x20 if a and b and a[0] else 0) | (0x8 if a is None else 0)
        if a is None:
            out.append((f1 | 0x4, b[1], "*", None, None))
        else:
            out.append((f1, a[1], a[2], a[3], a[4]))
        if b is None:
            out.append((f2 | 0x4, a[1], "*", None, None))
        else:
            out.append((f2, b[1], b[2], b[3], b[4]))
    return out


SW_LUT = np.full(256, 4, np.uint8)
for _chars, _code in ((b"Aa", 0), (b"Cc", 1), (b"Tt", 2), (b"Gg", 3),
                      (b"Uu", 0)):
    for _c in _chars:
        SW_LUT[_c] = _code


def parse_sam(text: str, names) -> dict:
    """{name: [(flag, pos, cigar, md, nm)]} of the lines of `names`."""
    want = set(names)
    out = {}
    for line in text.split("\n"):
        if not line or line[0] == "@":
            continue
        f = line.split("\t")
        if f[0] not in want:
            continue
        tags = {t[:2]: t[5:] for t in f[11:]}
        nm = tags.get("NM")
        out.setdefault(f[0], []).append(
            (int(f[1]), int(f[3]), f[5], tags.get("MD"),
             None if nm is None else int(nm)))
    return out
