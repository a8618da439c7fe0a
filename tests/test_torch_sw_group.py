"""The SW kernel's schedule (kslam_tpu_torch/csrc/sw_forward.cu) as a
numpy model, held exactly against the JAX forward pass
(kslam_tpu.ops.sw.sw_forward_batch) and the port's plain twin
(sw_cuda.sw_forward_batch_plain); and the wrapper's launch configuration.
The kernel itself runs only on a card (tests/test_torch_cuda.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kslam_tpu.ops import sw as jsw
from kslam_tpu_torch.ops import sw_cuda

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


def group_model(q, r, match, mismatch, go, ge, group, rows, n_valid=None):
    """sw_group_kernel (sw_forward.cu:95-219) step by step, vectorised
    over the batch: thread p of a group of `group` holds query rows
    p*rows .. p*rows+rows-1, padded with N past Lq (:154-165); at step s
    it updates column j = s - p (:172-181), taking H and F of the row
    above from thread p-1's previous step, as __shfl_up_sync does, with
    (0, NEG) at thread 0 (:174-179), and carrying diag_top (:183-184);
    the cell update (:186-201) in int32; its column max of (H << 20) - k
    plus the column and row parts of the key (:202-204); then the
    xor-shuffle max over the group (:209-210) and the decode (:211-218).
    Rows >= n_valid give (0, -1, 0) (:142-149).  The kernel takes the
    column max over two cells at a time (__vimax3_s32); max is
    associative, so the model takes it cell by cell."""
    b, lq = q.shape
    lr = r.shape[1]
    assert lq <= group * rows <= 1024
    byte = byte_scores(match, mismatch)
    qp = np.full((b, group * rows), 4, np.int64)
    qp[:, :lq] = q
    qp = qp.reshape(b, group, rows)
    sel = row_selectors(qp) if byte else qp
    words = column_words(r, match, mismatch) if byte else r
    i32 = np.int32
    h = np.zeros((b, group, rows), i32)
    e = np.zeros((b, group, rows), i32)
    best = np.zeros((b, group), i32)
    out_h = np.zeros((b, group), i32)
    out_f = np.full((b, group), NEG, i32)
    diag_top = np.zeros((b, group), i32)
    p_all = np.arange(group)
    row_key = ((1023 - p_all * rows) - (2 ** 20 - 1)).astype(i32)
    for s in range(lr + group - 1):
        top_h = np.concatenate([np.zeros((b, 1), i32), out_h[:, :-1]], 1)
        f_in = np.concatenate([np.full((b, 1), NEG, i32), out_f[:, :-1]], 1)
        lo, hi = max(0, s - lr + 1), min(group - 1, s)   # j in [0, lr)
        if lo > hi:
            continue
        act = slice(lo, hi + 1)
        jj = s - p_all[act]
        word = words[:, jj]
        diag = diag_top[:, act].copy()
        diag_top[:, act] = top_h[:, act]
        f = f_in[:, act]
        cm = np.full(word.shape, np.iinfo(i32).min, i32)
        for k in range(rows):
            if byte:
                sc = byte_perm(word, sel[:, act, k])
            else:
                qk = sel[:, act, k]
                sc = np.where((qk == 4) | (word == 4), 0,
                              np.where(qk == word, match, -mismatch))
            sc = sc.astype(i32)
            hp = np.maximum(np.maximum(diag + sc, e[:, act, k]), 0)
            diag = h[:, act, k].copy()
            hk = np.maximum(hp, f)
            f = np.maximum(hp - i32(go), f - i32(ge))
            e[:, act, k] = np.maximum(hk - i32(go), e[:, act, k] - i32(ge))
            h[:, act, k] = hk
            cm = np.maximum(cm, (hk << 20) - i32(k))
        key = cm + (((1023 - jj) << 10).astype(i32) + row_key[act])
        best[:, act] = np.maximum(best[:, act], key)
        out_h[:, act] = h[:, act, rows - 1]
        out_f[:, act] = f
    o = group // 2
    while o:
        best = np.maximum(best, best[:, p_all ^ o])
        o //= 2
    k2 = best[:, 0] + (2 ** 20 - 1)
    score = k2 >> 20
    pos = score > 0
    ref_end = np.where(pos, 1023 - ((k2 >> 10) & 1023), -1)
    read_end = np.where(pos, 1023 - (k2 & 1023), 0)
    if n_valid is not None:
        dead = np.arange(b) >= n_valid
        score = np.where(dead, 0, score)
        ref_end = np.where(dead, -1, ref_end)
        read_end = np.where(dead, 0, read_end)
    return score, ref_end, read_end


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
