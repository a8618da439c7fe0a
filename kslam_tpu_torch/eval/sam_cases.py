"""A synthetic mix of SAM alignments, richer in indels and clipped
windows than planted reads, for the checks of
ops/sam_cuda.py's kernels (chip_smoke.py, tests/test_torch_cuda.py,
tests/test_torch_sam_columns.py, tests/test_torch_sam_passes.py): reads
copied from a few entries with
substitutions and indels, forward or reverse-complemented, some with N,
lowercase or IUPAC bases, some at an entry's end or before its start
(rel_pos < 0), each with the overlap columns phase A hands the SAM text
(read_id, entry_id, rel_pos, rc; ref_begin, query_begin, query_end);
and a tie-heavy mix on tandem repeats.  All from a numpy Generator."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import encode, sam_cuda

ACGT = np.frombuffer(b"ACGT", np.uint8)


def entries(rng, n_entries: int = 4, length: int = 4000):
    """ASCII entries of uniform bases, each with an N run and a few IUPAC
    letters (which the SW codes read as N)."""
    out = []
    for _ in range(n_entries):
        e = ACGT[rng.integers(0, 4, length)]
        at = int(rng.integers(0, length - 40))
        e[at:at + int(rng.integers(5, 30))] = ord("N")
        iupac = rng.integers(0, length, 6)
        e[iupac] = np.frombuffer(b"RYKMSW", np.uint8)
        out.append(e)
    return out


def _mutate(rng, seq, sub: float, indel: float):
    """Substitutions, and runs of 1-3 deleted and inserted bases."""
    keep = np.ones(len(seq), bool)
    for at in np.flatnonzero(rng.random(len(seq)) < indel / 4):
        keep[at:at + int(rng.integers(1, 4))] = False
    seq = seq[keep].copy()
    hit = rng.random(len(seq)) < sub
    seq[hit] = ACGT[rng.integers(0, 4, int(hit.sum()))]
    ins = np.flatnonzero(rng.random(len(seq)) < indel / 2)
    if len(ins):
        runs = rng.integers(1, 4, len(ins))
        seq = np.insert(seq, np.repeat(ins, runs),
                        ACGT[rng.integers(0, 4, int(runs.sum()))])
    return seq


def _shift(rng, seq):
    """k inserted bases, then k deleted ones (k = 3..6) further on: the
    ends stay on one diagonal, the middle leaves it by k, so a band that
    starts at 1 doubles twice or more."""
    k = int(rng.integers(3, 7))
    a = int(rng.integers(10, max(len(seq) // 2 - k, 11)))
    b = int(rng.integers(a + k + 5, max(len(seq) - k - 5, a + k + 6)))
    seq = np.concatenate([seq[:a], ACGT[rng.integers(0, 4, k)], seq[a:b],
                          seq[b + k:]])
    return seq


def alignments(rng, ents, n: int, read_len: int = 150, stride: int = 160,
               sub: float = 0.02, indel_share: float = 0.3,
               indel: float = 0.02, end_share: float = 0.05,
               odd_share: float = 0.05, shift_share: float = 0.05):
    """n reads, one alignment each.  A read copies read_len bases of an
    entry at a random place (end_share of them from its last bases or
    from before its start), mutates them (indel_share of them with
    indels, shift_share with an insertion and a deletion of the same
    length), reverse-complements half of them, and an odd_share gets N,
    lowercase or a shorter length.  Returns a dict of numpy columns:
    bases (the entries' ASCII concatenated), offsets (int64), reads
    (uint8 [n, stride]), quality (uint8 [n, stride]), lengths (int32),
    read_id, entry_id, rel_pos (int32), rc (uint8)."""
    offs = np.cumsum([0] + [len(e) for e in ents]).astype(np.int64)
    reads = np.zeros((n, stride), np.uint8)
    qual = np.zeros((n, stride), np.uint8)
    lengths = np.zeros(n, np.int32)
    eid = rng.integers(0, len(ents), n).astype(np.int32)
    rel = np.zeros(n, np.int32)
    rc = (rng.random(n) < 0.5).astype(np.uint8)
    for k in range(n):
        e = ents[eid[k]]
        u = rng.random()
        if u < end_share / 2:
            pos = len(e) - int(rng.integers(20, read_len))
        elif u < end_share:
            pos = -int(rng.integers(1, 30))
        else:
            pos = int(rng.integers(0, len(e) - read_len))
        seg = e[max(pos, 0):max(pos, 0) + read_len + (pos if pos < 0
                                                        else 0)]
        seq = _mutate(rng, seg, sub, indel if rng.random() < indel_share
                      else 0.0)
        if len(seq) > 60 and rng.random() < shift_share:
            seq = _shift(rng, seq)
        if pos < 0:
            seq = np.concatenate([ACGT[rng.integers(0, 4, -pos)], seq])
        seq = seq[:min(read_len, stride)]
        if rng.random() < odd_share:
            kind = rng.integers(0, 3)
            if kind == 0:
                seq[rng.integers(0, len(seq), 3)] = ord("N")
            elif kind == 1:
                seq = np.frombuffer(seq.tobytes().lower(), np.uint8)
            else:
                seq = seq[:int(rng.integers(1, len(seq) + 1))]
        if rc[k]:
            seq = np.frombuffer(encode.reverse_complement_str(
                seq.tobytes().decode()).encode(), np.uint8)
        lengths[k] = len(seq)
        reads[k, :len(seq)] = seq
        qual[k, :len(seq)] = rng.integers(35, 75, len(seq))
        rel[k] = pos + int(rng.integers(-2, 3))
    return {"bases": np.concatenate(ents), "offsets": offs, "reads": reads,
            "quality": qual, "lengths": lengths,
            "read_id": np.arange(n, dtype=np.int32), "entry_id": eid,
            "rel_pos": rel, "rc": rc}


def tandem_alignments(rng, n: int, read_len: int = 150):
    """n alignments on tandem repeats (alignments()' columns): each of 3
    entries repeats a unit of 2-6 bases, each read the unit of its entry
    with half its bases changed (forward or rc), so every period scores
    below 0 and the max is a short run of matches that many cells reach:
    the tie-break decides every end."""
    units = [ACGT[rng.integers(0, 4, int(rng.integers(2, 7)))]
             for _ in range(3)]
    ents = [np.resize(u, max(10 * read_len, 1500)) for u in units]
    c = alignments(rng, ents, n, read_len=read_len, end_share=0.0,
                   odd_share=0.0)
    for k in range(n):
        u = units[c["entry_id"][k]].copy()
        at = rng.choice(len(u), -(-len(u) // 2), replace=False)
        u[at] = ACGT[(np.searchsorted(ACGT, u[at]) + 1) % 4]
        c["reads"][k, :c["lengths"][k]] = np.resize(u, c["lengths"][k])
    return c


def phase_a_ends(rng, ref_begin, query_begin, query_end, lengths,
                 share: float = 0.1):
    """ref_begin, query_begin, query_end as phase A gives them: the
    native cigar call's own for most rows, shifted by a few bases (its
    chunked windows find other ends) for a share of them."""
    n = len(ref_begin)
    move = rng.random(n) < share
    rb = np.where(move, ref_begin + rng.integers(-3, 4, n), ref_begin)
    qb = np.where(move, np.clip(query_begin + rng.integers(-2, 3, n), 0,
                                None), query_begin)
    qe = np.where(move, np.minimum(query_end + rng.integers(-2, 3, n),
                                   lengths - 1), query_end)
    return (rb.astype(np.int64), qb.astype(np.int32), qe.astype(np.int32))


def _put(a, device):
    return torch.as_tensor(np.ascontiguousarray(a)).to(device)


def cigar_operands(c: dict, device):
    """sam_cuda.sam_cigar's operands (before params) for the columns of
    alignments(), on device."""
    win, wlen, ref_start = sam_cuda.native_windows(
        c["bases"], c["offsets"], c["entry_id"], c["rel_pos"],
        c["lengths"][c["read_id"]], int(c["lengths"].max()))
    return tuple(_put(a, device) for a in (
        c["reads"], c["lengths"], c["read_id"], c["rc"], win, wlen,
        ref_start))


def diff_operands(c: dict, cigar_buf, cigar_len, ref_begin, query_begin,
                  query_end, device, pad: int = 16):
    """sam_cuda.sam_diff's operands for the columns of alignments(), the
    cigar columns given (numpy) and phase A's ends (phase_a_ends), on
    device; the windows pad bytes past the longest read, rounded up to
    16 B words as io/sam_columns rounds them."""
    dwin, dlen, _ = sam_cuda.diff_windows(
        c["bases"], c["offsets"], c["entry_id"], ref_begin,
        -(-(int(c["lengths"].max()) + pad) // 16) * 16)
    return tuple(_put(a, device) for a in (
        c["reads"], c["quality"], c["lengths"], c["lengths"], c["read_id"],
        c["rc"], query_begin, query_end, cigar_buf, cigar_len, dwin,
        dlen)) + sam_cuda.quality_tables(device)
