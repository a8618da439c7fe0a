"""sam_cigar's passes kernel (kslam_tpu_torch/csrc/sam.cu,
sam_pass_kernel) modelled in torch for the tests: its staging of the SAM
operands and its epilogue.  No jax import, so that the card tests
(tests/test_torch_cuda.py) use it too; keep it in step with the
kernel."""

import torch

from kslam_tpu_torch.ops.encode import _SW_TABLE


def stage_plain(reads, read_len, read_id, rc, win, wlen, params):
    """The passes kernel's staging: the query rows (the SW codes of each
    alignment's read, N past its length, [n, stride]), the window's
    columns as the block stages them (column j: the code of byte j, or
    for rc the complement of byte wlen - 1 - j; N past wlen, [n, W]),
    their byte-path score words (byte c: the score of query code c
    against the column, 0 for an N column; int64 [n, W]) and the first
    and last non-N column (wlen and -1 without one).  Returns (q, r,
    words, c0, c1)."""
    match, mismatch = int(params[0]), int(params[1])
    dev = reads.device
    tab = torch.as_tensor(_SW_TABLE, device=dev).long()
    rid = read_id.long()
    stride = reads.shape[1]
    m = read_len.long()[rid]
    i = torch.arange(stride, device=dev)
    q = torch.where(i[None, :] < m[:, None], tab[reads[rid].long()], 4)
    nw = wlen.long()
    width = win.shape[1]
    j = torch.arange(width, device=dev)[None, :]
    codes = tab[win.long()]
    back = torch.gather(codes, 1, (nw[:, None] - 1 - j).clamp(
        0, max(width - 1, 0))) if width else codes
    back = torch.where(back < 4, back ^ 2, back)
    r = torch.where(rc.bool()[:, None], back, codes)
    r = torch.where(j < nw[:, None], r, 4)
    byte = torch.arange(4, device=dev)[None, None, :]
    s = torch.where(byte == r[:, :, None], match, -mismatch) & 0xFF
    words = torch.where(r < 4, (s << (8 * byte)).sum(2), 0)
    real = r < 4
    c0 = torch.where(real, j, width).min(1).values if width else nw.clone()
    c0 = torch.where(real.any(1), c0, nw) if width else c0
    c1 = torch.where(real, j, -1).max(1).values if width else \
        torch.full_like(nw, -1)
    return q, r, words, c0, c1


def pass_columns(al, m, wlen, rc, ref_start):
    """The passes kernel's epilogue: score, ref_begin, ref_end,
    query_begin and query_end (int64, entry coordinates) from the two
    passes' SWAlignments in window coordinates (sw_align's: ref_begin -1
    at score 0) of query length m: the begins from the reverse pass, an
    empty read all zero, then the coordinates un-flipped for rc and moved
    by ref_start."""
    sc, rb, re, qb, qe = (x.long() for x in al)
    has = m.long() > 0
    sc, rb, re, qb, qe = (torch.where(has, x, 0) for x in (sc, rb, re, qb,
                                                            qe))
    rcb = rc.bool()
    nw, mm, rs = wlen.long(), m.long(), ref_start.long()
    rb_o = torch.where(rcb, nw - (re + 1), rb)
    re_o = torch.where(rcb, nw - (rb + 1), re)
    qb_o = torch.where(rcb, mm - (qe + 1), qb)
    qe_o = torch.where(rcb, mm - (qb + 1), qe)
    return sc, rb_o + rs, re_o + rs, qb_o, qe_o
