"""sam_cigar's forward and reverse passes as its group kernel computes
them (kslam_tpu_torch/csrc/sam.cu: the windows staged as score words,
then sw_align's wavefront), on the CPU:

  * the SAM operands staged as the kernel stages them
    (torch_sam_staging.stage_plain: the SW code table, the complement and
    reversal of rc windows, N past the read and the window) go through
    the group kernel's plain twin sw_cuda.sw_align_batch_plain; with the
    kernel's epilogue (torch_sam_staging.pass_columns) the score, begins
    and ends equal
    kslam_tpu.golden.ssw.slam_overlap_align's on every mix of
    test_torch_sam_columns.CIGAR_CASES, on tandem-repeat windows where
    many cells share the max, on reads at the group kernel's length
    limit, and on empty and all-N windows;
  * the staging equals the windows sam_cigar_plain builds, and its score
    words and column extents are what the kernel stages;
  * the group kernel's launch configuration and its limits;
  * the band kernel's lockstep row DP (a numpy model): its direction
    bytes equal the plain banded DP's cell for cell, and with the
    doubling and the traceback its cigar equals
    kslam_tpu.golden.ssw.banded_cigar's.

The card holds the kernel to sam_cigar_plain in tests/test_torch_cuda.py
and chip_smoke.py."""

import numpy as np
import pytest
import torch

from kslam_tpu.golden import ssw as jssw
from kslam_tpu_torch.eval import sam_cases
from kslam_tpu_torch.ops import encode, sam_cuda, sw_cuda
from tests.test_torch_sam_columns import CIGAR_CASES, PARAMS, SW, _columns
from tests.torch_sam_staging import pass_columns, stage_plain

torch.set_num_threads(1)

ACGT = np.frombuffer(b"ACGT", np.uint8)


def _long(seed: int, n: int, read_len: int):
    rng = np.random.default_rng(seed)
    ents = sam_cases.entries(rng, n_entries=2, length=4 * read_len)
    return sam_cases.alignments(rng, ents, n, read_len=read_len,
                                stride=read_len, indel_share=0.5,
                                end_share=0.2, odd_share=0.0)


def _empty_and_all_n(seed: int, n: int):
    """Windows of no base (rel_pos past the entry's end), windows of N
    only, and empty reads."""
    rng = np.random.default_rng(seed)
    ents = sam_cases.entries(rng, n_entries=2, length=1200)
    ents.append(np.full(600, ord("N"), np.uint8))
    c = sam_cases.alignments(rng, ents, n, end_share=0.0, odd_share=0.0)
    c["entry_id"][0::3] = 2                         # all N
    elen = np.diff(c["offsets"])[c["entry_id"]]
    past = np.arange(n) % 3 == 1
    c["rel_pos"][past] = elen[past] + rng.integers(0, 5, int(past.sum()))
    c["lengths"][5::7] = 0                          # empty reads
    c["reads"][5::7] = 0
    return c


def _case(case: str):
    """(columns, score_filter) of a case."""
    if case in CIGAR_CASES:
        kw, score_filter = CIGAR_CASES[case]
        c, _ = _columns(sum(map(ord, case)), 24, **kw)
        if case == "forward":
            c["rc"][:] = 0
        elif case == "rc":
            c["rc"][:] = 1
        return c, score_filter
    if case == "tie_heavy":
        return sam_cases.tandem_alignments(np.random.default_rng(41),
                                           24), 0
    if case == "length_limit":
        return _long(43, 4, 1023), 0
    return _empty_and_all_n(47, 21), 0


PASS_CASES = list(CIGAR_CASES) + ["tie_heavy", "length_limit",
                                  "empty_and_all_n"]


@pytest.mark.parametrize("case", PASS_CASES)
def test_group_passes_match_golden(case):
    c, _ = _case(case)
    ops = sam_cases.cigar_operands(c, "cpu")
    reads, read_len, read_id, rc, win, wlen, ref_start = ops
    assert sam_cuda.takes_group(reads.shape[1], win.shape[1], PARAMS)
    q, r, _, _, _ = stage_plain(reads, read_len, read_id, rc, win, wlen,
                                PARAMS)
    al = sw_cuda.sw_align_batch_plain(q, r, *PARAMS)
    m = read_len.long()[read_id.long()]
    got = pass_columns(al, m, wlen, rc, ref_start)
    codes = encode.sw_codes_np(c["bases"])
    ties = 0
    for k in range(len(c["read_id"])):
        e = c["entry_id"][k]
        read = encode.sw_codes_np(c["reads"][k, :c["lengths"][k]])
        want = jssw.slam_overlap_align(
            read, codes[c["offsets"][e]:c["offsets"][e + 1]],
            int(c["rel_pos"][k]), bool(c["rc"][k]), SW)
        assert tuple(int(x[k]) for x in got) == \
            (want.sw_score, want.ref_begin, want.ref_end, want.query_begin,
             want.query_end), (case, k)
        if case == "tie_heavy" and want.sw_score > 0:
            # another cell of the forward pass reaches the max score
            ref = r[k, :int(wlen[k])].numpy()
            ties += _cells_at_max(read, ref) > 1
    if case == "tie_heavy":
        assert ties >= len(c["read_id"]) // 2
    if case == "empty_and_all_n":
        assert (wlen == 0).any() and (got[0] == 0).any() and (m == 0).any()
    if case == "length_limit":
        assert int(m.max()) == 1023 and not sam_cuda.takes_group(
            1024, 1024, PARAMS)


def _cells_at_max(read, ref) -> int:
    """The forward pass's cells whose H equals its max, by a plain column
    scan (gap_open >= gap_extend)."""
    match, mismatch, go, ge = PARAMS
    m = len(read)
    h_prev = np.zeros(m, np.int64)
    e_prev = np.zeros(m, np.int64)
    hs = []
    for j in range(len(ref)):
        s = np.where((read == 4) | (ref[j] == 4), 0,
                     np.where(read == ref[j], match, -mismatch))
        diag = np.concatenate([[0], h_prev[:-1]])
        h = np.maximum(np.maximum(diag + s, 0), e_prev)
        f = np.full(m, -(1 << 40))
        for i in range(1, m):
            f[i] = max(h[i - 1] - go, f[i - 1] - ge)
        h = np.maximum(h, f)
        e_prev = np.maximum(np.maximum(h - go, e_prev - ge), 0)
        hs.append(h)
        h_prev = h
    hs = np.array(hs)
    return int((hs == hs.max()).sum())


@pytest.mark.parametrize("case", ["rc", "reads_with_n", "entry_end"])
def test_staging_matches_plain_windows(case, monkeypatch):
    """stage_plain's query rows and windows equal the ones sam_cigar_plain
    hands its forward pass; its score words hold, byte c, the score of
    query code c against the column; its extents are the first and last
    non-N column."""
    c, score_filter = _case(case)
    ops = sam_cases.cigar_operands(c, "cpu")
    seen = []
    real = sam_cuda.forward_ends_plain

    def record(q, m, r, n, *args):
        seen.append((q.clone(), m.clone(), r.clone(), n.clone()))
        return real(q, m, r, n, *args)
    monkeypatch.setattr(sam_cuda, "forward_ends_plain", record)
    sam_cuda.sam_cigar_plain(*ops, PARAMS, score_filter,
                             sam_cuda.native_max_ops(c["lengths"]))
    q_p, m_p, r_p, n_p = seen[0]
    q, r, words, c0, c1 = stage_plain(*ops[:6], PARAMS)
    assert torch.equal(q[:, :q_p.shape[1]], q_p)
    assert (q[:, q_p.shape[1]:] == 4).all()
    assert torch.equal(r, r_p) and torch.equal(ops[5].long(), n_p)
    for code in range(5):
        want = sam_cuda._sub(torch.tensor(code), r, *PARAMS[:2]) & 0xFF
        byte = (words >> (8 * code)) & 0xFF if code < 4 else \
            torch.zeros_like(words)
        assert torch.equal(byte, want), code
    rn = r.numpy()
    for k in range(len(rn)):
        real_cols = np.flatnonzero(rn[k] < 4)
        assert (int(c0[k]), int(c1[k])) == (
            (int(real_cols[0]), int(real_cols[-1])) if len(real_cols)
            else (int(ops[5][k]), -1)), k


@pytest.mark.parametrize("stride,width,want", [
    (160, 150, (8, 20, 128)),
    (150, 150, (8, 20, 128)),
    (1023, 1023, (32, 32, 128)),
    (20, 30, (1, 20, 128)),
    (4, 1024, (1, 4, 32)),
])
def test_cigar_config(stride, width, want):
    """The passes kernel's G and R as sw_align's launch_config takes them
    for Lq = stride; its block's shared memory (score words, extents, the
    code table) within one block's limit; the band region of a read of
    `stride` bases; the limits that send a batch to sam_cigar_long."""
    cfg = sam_cuda.cigar_config(32768, stride, width)
    assert (cfg.group, cfg.rows, cfg.threads) == want
    sw = sw_cuda.launch_config(32768, stride, width)
    assert (cfg.group, cfg.rows) == (sw.group, sw.rows)
    per = cfg.threads // cfg.group
    assert cfg.blocks == -(-32768 // per)
    assert cfg.col_stride >= width and cfg.col_stride % 32 == \
        cfg.group % 32
    assert per * (cfg.col_stride + 2) * 4 + 256 <= cfg.smem <= \
        sam_cuda.SMEM_BLOCK_LIMIT
    for w_cap in (1, 8, sam_cuda.relaunch_width(stride)):
        region = sam_cuda.band_region(stride, w_cap)
        assert region % 16 == 0 and 0 <= region - (
            12 * sam_cuda.band_ints(w_cap) + stride * (2 * w_cap + 1)) < 16
    assert sam_cuda.takes_group(stride, width, PARAMS)
    assert not sam_cuda.takes_group(stride, width, (2, 3, 2, 5))
    assert not sam_cuda.takes_group(1025, width, PARAMS)
    assert not sam_cuda.takes_group(stride, 1025, PARAMS)


def _warp_band_model(rd, rf, w: int, lanes: int):
    """numpy model of csrc/sam.cu's lockstep_band_dp for one alignment:
    the rows in order, each row's cells `lanes` at a time, a chunk's reads
    of the band rows before its writes, F by the chunk's max-plus scan
    with carries from the chunks before, the edge's zeros written only
    where no write of the row covers them.  Returns (max score, direction
    bytes [len(rd) * (2 w + 1)])."""
    match, mismatch, go, ge = PARAMS
    n_rd, n_rf = len(rd), len(rf)
    width, width_d = 2 * w + 3, 2 * w + 1
    hb, eb, hc = (np.zeros(2 * w + 6, np.int64) for _ in range(3))
    dirs = np.zeros(max(n_rd * width_d, 1), np.int64)
    best, u_last = 0, 0
    for i in range(n_rd):
        beg, end = max(i - w, 0), min(i + w, n_rf - 1)
        edge = min(end + 1, width - 1)
        n_cells = max(end - beg + 1, 0)
        s = beg - max(i - 1 - w, 0)
        carry_a, carry_h, carry_f = -ge, 0, 0
        for k0 in range(0, n_cells, lanes):
            k = np.arange(k0, min(k0 + lanes, n_cells))
            u = k + 1
            ei, d = u + s, u + s - 1
            hbe = np.where(ei == edge, 0, hb[ei])
            ebe = np.where(ei == edge, 0, eb[ei])
            hbd = np.where(d == edge, 0, hb[d])
            t1 = np.full_like(k, -go) if i == 0 else hbe - go
            t2 = np.full_like(k, -ge) if i == 0 else ebe - ge
            e_new = np.maximum(t1, t2)
            d0 = t1 > t2
            e1 = np.maximum(e_new, 0)
            r = rf[beg + k]
            sub = np.where((rd[i] == 4) | (r == 4), 0,
                           np.where(rd[i] == r, match, -mismatch))
            t2d = hbd + sub
            h0 = np.maximum(e1, t2d)
            incl = np.maximum.accumulate(h0 + k * ge)
            excl = np.maximum(carry_a, np.concatenate([[carry_a],
                                                       incl[:-1]]))
            f = np.maximum(-(k + 1) * ge, excl - go - (k - 1) * ge)
            f1 = np.maximum(f, 0)
            h = np.maximum(h0, f1)
            hp = np.concatenate([[carry_h], h[:-1]])
            fp = np.concatenate([[carry_f], f[:-1]])
            d1 = (hp - go) > (fp - ge)
            d2 = np.where(np.maximum(e1, f1) <= t2d, 1,
                          np.where(e1 > f1, np.where(d0, 3, 2),
                                   np.where(d1, 5, 4)))
            carry_a = max(carry_a, int(incl[-1]))
            carry_h, carry_f = int(h[-1]), int(f[-1])
            eb[u] = e_new
            hc[u] = h
            dirs[i * width_d + k] = d0 | (d1 << 1) | (d2 << 2)
            best = max(best, int(h.max()))
        if n_cells > 0:
            u_last = n_cells
        hb[1:u_last + 1] = hc[1:u_last + 1]
        if edge > n_cells:
            eb[edge] = 0
        if edge > u_last:
            hb[edge] = 0
    return best, dirs[:n_rd * width_d]


def _model_cigar(rd, rf, score: int, w: int, lanes: int):
    """csrc/sam.cu's lockstep_band_cigar on the model: the band doubles
    until the DP reaches score, then the traceback (sam.cu's traceback)
    reads the packed direction bytes at the native's flat index.  Returns
    the cigar as golden.ssw.banded_cigar gives it, "error" on an unwritten
    cell (the golden's trace back error), or None when the traceback
    leaves its band row (where the native's flat index and the golden's
    row index part)."""
    while _warp_band_model(rd, rf, w, lanes)[0] < score:
        w *= 2
    dirs = _warp_band_model(rd, rf, w, lanes)[1]
    width_d = 2 * w + 1
    i, j = len(rd) - 1, len(rf) - 1
    e = f = run_op = 0
    temp2 = 2
    ops = []
    while i > 0:
        col = (j - max(i - w, 0)) * 3 + temp2
        if not 0 <= col < width_d * 3:
            return None
        idx = i * width_d * 3 + col
        cell, layer = int(dirs[idx // 3]), idx % 3
        d = 0 if cell == 0 else ((3 if cell & 1 else 2) if layer == 0 else
                                 (5 if cell & 2 else 4) if layer == 1 else
                                 cell >> 2)
        if d == 0:
            return "error"
        i -= d <= 3
        j -= d in (1, 4, 5)
        temp2 = {1: 2, 2: 0, 3: 2, 4: 1, 5: 2}[d]
        f = 0 if d == 1 else (1 if d <= 3 else 2)
        if f == run_op:
            e += 1
        else:
            ops.append((e, run_op))
            run_op, e = f, 1
    ops += [(e + 1, 0)] if f == 0 else [(e, f), (1, 0)]
    return [(n, "MID"[op]) for n, op in reversed(ops)]


@pytest.mark.parametrize("w,lanes", [(1, 32), (3, 32), (8, 32), (8, 4),
                                     (24, 32), (40, 8)])
def test_warp_band_model_matches_plain_dp(w, lanes):
    """The band kernel's row-parallel DP (modelled in numpy, chunks of
    `lanes` cells) gives the plain banded DP's max and direction bytes,
    cell for cell, and with the doubling and the traceback the golden
    banded_cigar's cigar (kslam_tpu.golden.ssw), on sub-reads and
    sub-windows of every shape the traceback meets: equal, longer or
    shorter reads than windows, N on both sides, bands narrower and wider
    than the read; scores reached at the first band and only after
    doubling."""
    rng = np.random.default_rng(w * 100 + lanes)
    traced = 0
    for trial in range(12):
        n_rd = int(rng.integers(1, 90))
        n_rf = max(n_rd + int(rng.integers(-6, 7)), 0)
        rf = rng.integers(0, 4, n_rf)
        rd = rf[:n_rd].copy() if n_rf >= n_rd else np.concatenate(
            [rf, rng.integers(0, 4, n_rd - n_rf)])
        hit = rng.random(n_rd) < 0.1
        rd[hit] = rng.integers(0, 5, int(hit.sum()))
        if trial % 3 == 0 and n_rf:
            rf[rng.integers(0, n_rf, 2)] = 4
        want_max, want_dirs = sam_cuda._banded_dp(
            torch.as_tensor(rd[None]), torch.tensor([n_rd]),
            torch.as_tensor(rf[None].reshape(1, -1)), torch.tensor([n_rf]),
            torch.tensor([w]), *PARAMS)
        got_max, got_dirs = _warp_band_model(rd, rf, w, lanes)
        assert got_max == int(want_max[0]), (trial, n_rd, n_rf)
        np.testing.assert_array_equal(
            got_dirs, want_dirs[0, :n_rd * (2 * w + 1)].numpy())
        # from the native's first band (|ref - read| + 1, or w where it is
        # wider): the score of a covering band, reached after doubling, on
        # odd trials; the first band's own max on even ones
        start = max(abs(n_rf - n_rd) + 1, 1 if trial % 2 else w)
        cover = max(n_rd, n_rf, 1)
        score = _warp_band_model(rd, rf, cover, lanes)[0] if trial % 2 \
            else _warp_band_model(rd, rf, start, lanes)[0]
        if score <= 0:
            continue
        got = _model_cigar(rd, rf, score, start, lanes)
        if got is None:
            continue
        if got == "error":
            with pytest.raises(RuntimeError, match="trace back error"):
                jssw.banded_cigar(rd, rf, score, SW, start)
        else:
            assert got == jssw.banded_cigar(rd, rf, score, SW, start), \
                (trial, n_rd, n_rf, score)
        traced += 1
    assert traced >= 9
