"""The SW kernels' schedule (kslam_tpu_torch/csrc/sw_forward.cu) as a
numpy model, held exactly against the JAX package and the port's plain
versions: the forward-only kernel against kslam_tpu.ops.sw.sw_forward_batch
and sw_cuda.sw_forward_batch_plain; the fused forward + reverse kernel
(column extents, trimmed forward pass, reverse pass read backwards from
the staged columns) against kslam_tpu.ops.sw.sw_align_batch,
kslam_tpu.ops.sw.align_overlaps_batch_chunked and the port's plain
composition; and the wrapper's launch configuration.  The kernels
themselves run only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kslam_tpu.ops import sw as jsw
from kslam_tpu_torch.eval.sw_windows import column_extents, n_windows
from kslam_tpu_torch.ops import sw, sw_cuda

torch.set_num_threads(1)

NEG = np.int32(-(2 ** 30))
PARAMS = [(2, 3, 5, 2), (1, 4, 6, 1), (3, 2, 2, 2)]
SHAPES = [(160, 192, 8, 20), (150, 192, 8, 20), (161, 40, 8, 24),
          (17, 33, 4, 8), (1, 1, 1, 4), (100, 150, 16, 8)]


def byte_scores(match, mismatch):
    """launch_rows (sw_forward.cu): int8 score words when match and
    -mismatch fit a signed byte, else the compare-and-select path."""
    return -128 <= match <= 127 and -128 <= -mismatch <= 127


def byte_perm(a, sel):
    """prmt a, 0, sel (__byte_perm(a, 0, sel)): output byte n is byte
    (nibble n & 7) of the 8-byte value (a, 0), or that byte's sign
    replicated when bit 3 of the nibble is set."""
    a = a.astype(np.int64) & 0xFFFFFFFF
    sel = sel.astype(np.int64)
    out = np.zeros(np.broadcast(a, sel).shape, np.int64)
    for n in range(4):
        nib = (sel >> (4 * n)) & 0xF
        src = nib & 7
        byte = np.where(src < 4, (a >> (8 * (src & 3))) & 0xFF, 0)
        byte = np.where(nib & 8, np.where(byte & 0x80, 0xFF, 0), byte)
        out |= byte << (8 * n)
    return (out - ((out >> 31) << 32)).astype(np.int32)


def column_words(r, match, mismatch):
    """column_word<true> (sw_forward.cu:61-68): byte c holds the score of
    query code c against the column; an N column is all zero."""
    mm_rep = ((-mismatch) & 0xFF) * 0x01010101
    sh = 8 * np.minimum(r, 3).astype(np.int64)
    w = (mm_rep & ~(0xFF << sh)) | ((match & 0xFF) << sh)
    return np.where(r >= 4, 0, w)


def row_selectors(q):
    """row_selector (sw_forward.cu:72-75)."""
    c = q.astype(np.int64) & 7
    return c | ((c | 8) * 0x1110)


def _group_pass(words, col_index, key_col0, ncols, lanes, sel, group, rows,
                match, mismatch, go, ge, byte):
    """group_pass (sw_forward.cu) step by step, vectorised over the batch:
    thread p of a group of `group` holds rows p*rows .. p*rows+rows-1
    (their selectors in sel [b, group, rows]); at step s it updates pass
    column jj = s - p when 0 <= jj < ncols, reading the staged word
    words[:, col_index(jj)], taking H and F of the row above from thread
    p-1's previous step, as __shfl_up_sync does, with (0, NEG) at thread
    0, and carrying diag_top; the cell update in int32; its column max of
    (H << 20) - k plus the column part ((1023 - key_col0 - jj) << 10) and
    row part of the key; ncols + lanes - 1 steps (none when ncols <= 0);
    then the xor-shuffle max over the group.  The kernel takes the column
    max over two cells at a time (__vimax3_s32); max is associative, so
    the model takes it cell by cell.  Returns the max key [b]."""
    b = words.shape[0]
    lr = words.shape[1]
    i32 = np.int32
    h = np.zeros((b, group, rows), i32)
    e = np.zeros((b, group, rows), i32)
    best = np.zeros((b, group), i32)
    out_h = np.zeros((b, group), i32)
    out_f = np.full((b, group), NEG, i32)
    diag_top = np.zeros((b, group), i32)
    p_all = np.arange(group)
    col_row_key = (((1023 - key_col0[:, None]) << 10)
                   + (1023 - p_all * rows)[None, :]
                   - (2 ** 20 - 1)).astype(i32)
    steps = np.where(ncols > 0, ncols + lanes - 1, 0)
    for s in range(int(steps.max(initial=0))):
        top_h = np.concatenate([np.zeros((b, 1), i32), out_h[:, :-1]], 1)
        f = np.concatenate([np.full((b, 1), NEG, i32), out_f[:, :-1]], 1)
        jj = s - p_all
        act = (jj >= 0)[None, :] & (jj[None, :] < ncols[:, None]) & \
            (s < steps)[:, None]
        if not act.any():
            continue
        word = np.take_along_axis(
            words, np.clip(col_index(np.broadcast_to(jj, (b, group))), 0,
                           lr - 1), axis=1)
        diag = diag_top.copy()
        diag_top = np.where(act, top_h, diag_top)
        cm = np.full((b, group), np.iinfo(i32).min, i32)
        for k in range(rows):
            if byte:
                sc = byte_perm(word, sel[:, :, k])
            else:
                qk = sel[:, :, k]
                sc = np.where((qk == 4) | (word == 4), 0,
                              np.where(qk == word, match, -mismatch))
            sc = sc.astype(i32)
            hp = np.maximum(np.maximum(diag + sc, e[:, :, k]), 0)
            diag = h[:, :, k].copy()
            hk = np.maximum(hp, f)
            f = np.maximum(hp - i32(go), f - i32(ge))
            e[:, :, k] = np.where(
                act, np.maximum(hk - i32(go), e[:, :, k] - i32(ge)),
                e[:, :, k])
            h[:, :, k] = np.where(act, hk, h[:, :, k])
            cm = np.maximum(cm, (hk << 20) - i32(k))
        key = cm + (col_row_key - (jj << 10)[None, :].astype(i32))
        best = np.where(act, np.maximum(best, key), best)
        out_h = np.where(act, h[:, :, rows - 1], out_h)
        out_f = np.where(act, f, out_f)
    o = group // 2
    while o:
        best = np.maximum(best, best[:, p_all ^ o])
        o //= 2
    return best[:, 0]


def _decode(best):
    """decode (sw_forward.cu): (score, column, row) of a max key, with
    (0, -1, 0) at score 0."""
    k2 = best + (2 ** 20 - 1)
    score = k2 >> 20
    pos = score > 0
    return (score, np.where(pos, 1023 - ((k2 >> 10) & 1023), -1),
            np.where(pos, 1023 - (k2 & 1023), 0))


def group_model(q, r, match, mismatch, go, ge, group, rows, n_valid=None,
                align=False):
    """sw_group_kernel (sw_forward.cu) step by step.  Forward only
    (align=False): the selectors of rows p*rows + k, N past Lq, one pass
    over every column, decoded to (score, ref_end, read_end); rows >=
    n_valid give (0, -1, 0).  Fused (align=True): the column extents c0,
    c1 found while staging, the forward pass over c0..c1 (key column
    c0 + jj), then, for rows with score > 0, the reverse pass from the
    same staged words read backwards (pass column jj reads column
    ref_end - jj, jj <= ref_end - c0; reverse row i holds query row
    read_end - i, N past read_end; ceil((read_end + 1) / rows) live
    threads), giving (score, ref_begin, ref_end, query_begin, query_end);
    rows >= n_valid give (0, -1, -1, 0, 0)."""
    b, lq = q.shape
    lr = r.shape[1]
    assert lq <= group * rows <= 1024
    byte = byte_scores(match, mismatch)
    qp = np.full((b, group * rows), 4, np.int64)
    qp[:, :lq] = q
    qp = qp.reshape(b, group, rows)
    sel = row_selectors(qp) if byte else qp
    words = column_words(r, match, mismatch) if byte else r
    args = (group, rows, match, mismatch, go, ge, byte)
    lanes = np.full(b, group)
    if align:
        c0, c1 = column_extents(r)
    else:
        c0, c1 = np.zeros(b, np.int64), np.full(b, lr - 1)
    score, ref_end, read_end = _decode(_group_pass(
        words, lambda jj: c0[:, None] + jj, c0, c1 - c0 + 1, lanes, sel,
        *args))
    dead = np.arange(b) >= (b if n_valid is None else n_valid)
    if not align:
        return (np.where(dead, 0, score), np.where(dead, -1, ref_end),
                np.where(dead, 0, read_end))
    pos = score > 0
    i = np.arange(group * rows)[None, :]
    src = read_end[:, None] - i
    rq = np.where(src >= 0, np.take_along_axis(q, np.clip(src, 0, lq - 1),
                                               axis=1),
                  4).reshape(b, group, rows)
    rsel = row_selectors(rq) if byte else rq
    _, rev_col, rev_row = _decode(_group_pass(
        words, lambda jj: ref_end[:, None] - jj, np.zeros(b, np.int64),
        np.where(pos, ref_end - c0 + 1, 0), (read_end + rows) // rows, rsel,
        *args))
    ref_begin = np.where(pos, ref_end - rev_col, -1)
    query_begin = np.where(pos, read_end - rev_row, 0)
    out = (score, ref_begin, ref_end, query_begin, read_end)
    return tuple(np.where(dead, d, x) for x, d in
                 zip(out, (0, -1, -1, 0, 0)))


def _inputs(rng, b, lq, lr):
    """Mutated copies of the query planted in random refs, 5% N, every
    fifth query all N."""
    q = rng.integers(0, 4, (b, lq)).astype(np.int32)
    r = rng.integers(0, 4, (b, lr)).astype(np.int32)
    n = min(lq, lr)
    off = rng.integers(0, lr - n + 1, b)
    cp = q[:, :n].copy()
    m = rng.random((b, n)) < 0.1
    cp[m] = rng.integers(0, 4, int(m.sum()))
    np.put_along_axis(r, off[:, None] + np.arange(n)[None, :], cp, axis=1)
    q[rng.random((b, lq)) < 0.05] = 4
    r[rng.random((b, lr)) < 0.05] = 4
    q[::5] = 4
    return q, r


def _check(lq, lr, group, rows, params):
    rng = np.random.default_rng(lq * 1000 + lr)
    b, nv = 24, 19
    q, r = _inputs(rng, b, lq, lr)
    got = group_model(q, r, *params, group, rows, n_valid=nv)
    twin = sw_cuda.sw_forward_batch_plain(torch.as_tensor(q),
                                          torch.as_tensor(r), *params,
                                          n_valid=nv)
    for a, t in zip(got, twin):
        np.testing.assert_array_equal(a, t.numpy())
    jout = jsw.sw_forward_batch(jnp.asarray(q), jnp.asarray(r), *params)
    # the JAX scan ignores n_valid: live rows equal it, dead rows are the
    # kernel's (0, -1, 0)
    for a, j in zip(got, jout):
        np.testing.assert_array_equal(a[:nv], np.asarray(j)[:nv])
    assert (got[0][nv:] == 0).all() and (got[1][nv:] == -1).all()
    assert (got[0][::5] == 0).all()             # all-N queries
    assert got[0][:nv].max() > 0


@pytest.mark.parametrize("params", PARAMS, ids=["p0", "p1", "p2"])
@pytest.mark.parametrize("lq,lr,group,rows", SHAPES)
def test_group_model_matches_jax_and_twin(lq, lr, group, rows, params):
    _check(lq, lr, group, rows, params)


@pytest.mark.parametrize("lq,lr,group,rows", [(10, 40, 4, 4), (8, 33, 2, 4),
                                              (1, 1, 1, 4)])
def test_group_model_wide_scores(lq, lr, group, rows):
    """Scores outside int8 take the compare-and-select path."""
    _check(lq, lr, group, rows, (200, 150, 300, 10))


def test_selectors_score_every_code_pair():
    """One permute of the column word by the row selector gives the
    pair score for every (query, ref) code, N included."""
    for match, mismatch in ((2, 3), (1, 4), (127, 128), (0, 0)):
        qc, rc = np.meshgrid(np.arange(5), np.arange(5), indexing="ij")
        got = byte_perm(column_words(rc, match, mismatch), row_selectors(qc))
        want = np.where((qc == 4) | (rc == 4), 0,
                        np.where(qc == rc, match, -mismatch))
        np.testing.assert_array_equal(got, want)
    assert byte_scores(127, 128)
    assert not byte_scores(128, 3) and not byte_scores(2, 129)


@pytest.mark.parametrize("lq,lr", [(1, 1), (7, 5), (20, 192), (150, 192),
                                   (160, 192), (161, 192), (160, 160),
                                   (20, 1024), (1024, 1024)])
def test_launch_config(lq, lr):
    for b in (1, 10, 300, 1000, 4096, 32768, 65536, 10 ** 6):
        cfg = sw_cuda.launch_config(b, lq, lr)
        g, rows = cfg.group, cfg.rows
        assert g in (1, 2, 4, 8, 16, 32) and rows in sw_cuda.KERNEL_ROWS
        assert lq <= g * rows <= 1024
        assert 32 * g >= lq and (g == 1 or 16 * g < lq)
        assert cfg.threads % 32 == 0
        assert g <= cfg.threads <= sw_cuda.MAX_THREADS
        per_block = cfg.threads // g
        assert cfg.blocks == -(-b // per_block)
        assert cfg.stride >= lr and cfg.stride % 32 == g % 32
        assert cfg.smem == per_block * cfg.stride * 4
        assert cfg.smem <= sw_cuda.SMEM_BLOCK_LIMIT <= 227 * 1024


def test_launch_config_fits_the_main_path():
    """Lq = 160 fits G * R exactly at every batch; Lq = 1024 takes a
    full warp per alignment."""
    for b in (1000, 32768, 65536):
        cfg = sw_cuda.launch_config(b, 160, 192)
        assert (cfg.group, cfg.rows, cfg.threads) == (8, 20, 128)
    assert sw_cuda.launch_config(100, 1024, 1024)[:2] == (32, 32)


@pytest.mark.parametrize("b,lq,lr", [(0, 10, 10), (10, 0, 10), (10, 10, 0),
                                     (10, 1025, 10), (10, 10, 1025)])
def test_launch_config_refuses_past_the_limits(b, lq, lr):
    with pytest.raises(ValueError):
        sw_cuda.launch_config(b, lq, lr)


def _align_inputs(rng, b, lq, lr):
    """_inputs plus the windows the fused kernel trims (n_windows)."""
    return n_windows(rng, *_inputs(rng, b, lq, lr))


def _same(got, want, rows=slice(None)):
    for a, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a)[rows],
                                      np.asarray(w)[rows])


ALIGN_SHAPES = [(1, 1, 1, 4), (7, 12, 1, 8), (17, 40, 4, 8),
                (100, 150, 16, 8), (160, 160, 8, 20), (160, 192, 8, 20)]
# Lq = 1024 (G * R = 1024, the key's row limit) needs match 1
ALIGN_CASES = [(*shape, params) for shape in ALIGN_SHAPES
               for params in PARAMS] + [(1024, 300, 32, 32, (1, 4, 6, 1))]


@pytest.mark.parametrize(
    "lq,lr,group,rows,params", ALIGN_CASES,
    ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-p{PARAMS.index(c[4])}"
         for c in ALIGN_CASES])
def test_fused_model_matches_jax_and_plain(lq, lr, group, rows, params):
    """The fused schedule equals JAX's sw_align_batch on the live rows and
    the port's plain composition on every row (n_valid = B - 1)."""
    rng = np.random.default_rng(lq * 7 + lr)
    b = 6 if lq > 200 else 24
    q, r = _align_inputs(rng, b, lq, lr)
    got = group_model(q, r, *params, group, rows, n_valid=b - 1, align=True)
    plain = sw_cuda.sw_align_batch_plain(torch.as_tensor(q),
                                         torch.as_tensor(r), *params,
                                         n_valid=b - 1)
    _same(got, [t.numpy() for t in plain])
    _same(got, jsw.sw_align_batch(jnp.asarray(q), jnp.asarray(r), *params),
          slice(0, b - 1))
    assert got[0][b - 1] == 0 and got[1][b - 1] == -1 and got[2][b - 1] == -1
    score = got[0][:b - 1]
    assert (score == 0).any() and (score > 0).any()
    if lr > 1:
        c0, _ = column_extents(r[:b - 1])
        assert ((c0 > 0) & (score > 0)).any()     # trimmed leading columns


def test_fused_model_wide_scores():
    """Scores outside int8 take the compare-and-select path."""
    rng = np.random.default_rng(77)
    params = (200, 150, 300, 10)
    for lq, lr, group, rows in ((10, 40, 4, 4), (8, 33, 2, 4)):
        q, r = _align_inputs(rng, 24, lq, lr)
        got = group_model(q, r, *params, group, rows, align=True)
        _same(got, jsw.sw_align_batch(jnp.asarray(q), jnp.asarray(r),
                                      *params))
        assert got[0].max() > 200


def _chunked_case(rng, b, l):
    """Candidates over a two-entry genome with a homopolymer, a
    microsatellite and an N run: half of the reads copied (3% mutated)
    from their window, forward or reverse-complemented; windows clipped
    at the entry end and at negative offsets; reads shorter than l."""
    genome = rng.integers(0, 4, 12_000).astype(np.uint8)
    genome[2000:2300] = 0
    genome[4000:4400] = np.tile(np.array([0, 1, 1, 3, 2], np.uint8), 80)
    genome[6000:6040] = 4
    offsets = np.array([0, 7000, 12_000], np.int64)
    chunks = sw.genome_chunks_from_scodes(genome)
    entry = rng.integers(0, 2, b).astype(np.int32)
    e_len = np.diff(offsets)[entry]
    rel = (rng.random(b) * (e_len - l // 2)).astype(np.int32) - 10
    rel[::5] = rng.choice([1990, 2100, 3980, 4100, 5990], len(rel[::5]))
    entry[::5] = 0
    rel[3::11] = e_len[3::11] - l // 3                # clipped at the end
    rc = rng.random(b) < 0.5
    lens = rng.integers(l // 2, l + 1, b).astype(np.int32)
    reads = rng.integers(0, 4, (b, l)).astype(np.uint8)
    for t in range(0, b, 2):
        s = int(offsets[entry[t]]) + max(int(rel[t]), 0) + \
            int(rng.integers(-4, 5))
        s = min(max(s, 0), len(genome) - l)
        seg = genome[s:s + l].copy()
        if rc[t]:
            seg = np.where(seg < 4, seg ^ 2, seg)[::-1]
        m = rng.random(l) < 0.03
        seg[m] = rng.integers(0, 4, int(m.sum()))
        reads[t] = seg
    args = (np.arange(b, dtype=np.int32), entry, rel, rc, np.ones(b, bool),
            reads, lens, chunks, offsets)
    return args


CHUNKED_CASES = [("zero", 0), ("one", 1), ("b-1", 2), ("b", 0), ("b", 1),
                 ("b", 2)]


@pytest.mark.parametrize("nv_kind,p", CHUNKED_CASES,
                         ids=[f"{k}-p{p}" for k, p in CHUNKED_CASES])
def test_fused_model_matches_jax_chunked(nv_kind, p):
    """The fused schedule over align_overlaps_batch_chunked's windows,
    mapped to entry coordinates, equals JAX's align_overlaps_batch_chunked
    (the XLA backend: forward pass, fixed flips and masks, forward pass)
    on the live rows and the port's CPU path on every row."""
    params = PARAMS[p]
    rng = np.random.default_rng(31)
    b, l = 20, 160
    args = _chunked_case(rng, b, l)
    nv = {"zero": 0, "one": 1, "b-1": b - 1, "b": b}[nv_kind]
    targs = [torch.as_tensor(x) for x in args]
    win = sw.chunked_windows(*targs[:4], *targs[5:], window_len=l)
    assert win.r.shape == (b, 192)
    cfg = sw_cuda.launch_config(b, l, 192, align=True)
    model = group_model(win.q.numpy(), win.r.numpy(), *params, cfg.group,
                        cfg.rows, n_valid=nv, align=True)
    got = sw.chunked_coordinates(
        sw.SWAlignments(*(torch.as_tensor(x.astype(np.int32))
                          for x in model)), win, targs[3])
    port = sw.align_overlaps_batch_chunked(*targs, *params, window_len=l,
                                           n_valid=torch.tensor(nv))
    _same([t.numpy() for t in got], [t.numpy() for t in port])
    jout = jsw.align_overlaps_batch_chunked(
        *(jnp.asarray(x) for x in args), *params, window_len=l,
        backend="xla", n_valid=jnp.asarray(nv, jnp.int32))
    _same([t.numpy() for t in got], jout, slice(0, nv))
    assert (model[0][nv:] == 0).all() and (model[1][nv:] == -1).all()
    if nv == b:
        score = model[0]
        # the planted (even) rows align far better than the random ones
        assert score[::2].mean() > 2 * score[1::2].mean() > 0
        c0, c1 = column_extents(win.r.numpy())
        assert (c0 > 0).all() and (c1 < 191).all()


@pytest.mark.parametrize("lq,lr", [(1, 1), (7, 5), (160, 192), (160, 160),
                                   (20, 1024), (1024, 1024)])
def test_launch_config_align(lq, lr):
    """The fused kernel's shared memory: the forward kernel's column
    words plus two extent words per alignment, the same G, R and (at
    these shapes) the same block."""
    for b in (1, 300, 32768, 10 ** 6):
        fwd = sw_cuda.launch_config(b, lq, lr)
        cfg = sw_cuda.launch_config(b, lq, lr, align=True)
        per_block = cfg.threads // cfg.group
        assert cfg[:3] == fwd[:3] and cfg.stride == fwd.stride
        assert cfg.smem == per_block * (cfg.stride + 2) * 4
        assert cfg.smem == fwd.smem + 8 * per_block
        assert cfg.smem <= sw_cuda.SMEM_BLOCK_LIMIT
    assert sw_cuda.launch_config(32768, 160, 192, align=True).smem == \
        16 * 202 * 4
