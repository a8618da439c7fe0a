"""The float32 device pseudo-assembly of kslam_tpu_torch
(ops/screens_dev.pseudo_assembly_device, pipeline/device_path.phase_b)
against kslam_tpu's, exactly, on the CPU: random pair columns with zero
spans, single-row chains, long chains, reversed spans and a chain whose
score saturates the float -> int64 conversion; then phase B of a real
phase A output."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kslam_tpu.ops import lca as jlca, screens_dev as jscreens
from kslam_tpu.pipeline import device_path as jdp
from kslam_tpu_torch.ops import lca, screens_dev
from kslam_tpu_torch.pipeline import device_path
from tests.test_torch_device_path import (  # noqa: F401
    _max_insert, _phase_a_both, _valid_rows, setup)

torch.set_num_threads(1)

_jit_pseudo = jax.jit(jscreens.pseudo_assembly_device)


def _random_cols(seed: int, p: int):
    """Columns as the reference's dtypes: (group, r1, r2, combined_score
    int32 bits of uint32 scores, entry, ref_start, ref_end, insert
    uint32, valid)."""
    rng = np.random.default_rng(seed)
    entry = rng.integers(0, 4, p).astype(np.int32)
    entry[rng.random(p) < 0.1] = 9            # sparse entry: 1-row chains
    start = rng.integers(0, 3000, p).astype(np.int32)
    start[entry == 9] *= 50
    span = rng.integers(60, 160, p).astype(np.int32)
    span[rng.random(p) < 0.1] = 0             # zero spans
    span[rng.random(p) < 0.05] *= -1          # ref_end before ref_start
    score = rng.integers(0, 2**32, p, dtype=np.uint64)
    score[rng.random(p) < 0.5] %= 400
    return (rng.integers(0, 40, p).astype(np.int32),
            rng.integers(-1, p, p).astype(np.int32),
            rng.integers(-1, p, p).astype(np.int32),
            score.astype(np.uint32).view(np.int32), entry, start,
            (start + span).astype(np.int32),
            rng.integers(0, 600, p).astype(np.uint32),
            rng.random(p) < 0.85)


def _saturating_cols():
    """One chain whose float32 score exceeds 2^63: three rows spanning
    [0, 2^31 - 2] and six one-base rows with the largest uint32 score."""
    big = 2**31 - 2
    start = np.array([0, 0, 0, 100, 101, 102, 103, 104, 105], np.int32)
    end = np.array([big, big, big, 101, 102, 103, 104, 105, 106], np.int32)
    score = np.array([1, 1, 1] + [2**32 - 1] * 6, np.uint64)
    p = len(start)
    return (np.arange(p, dtype=np.int32), np.zeros(p, np.int32),
            np.full(p, -1, np.int32), score.astype(np.uint32).view(np.int32),
            np.zeros(p, np.int32), start, end, np.zeros(p, np.uint32),
            np.ones(p, bool))


def _both(cols):
    """(port, reference) pseudo_assembly_device of the same columns; the
    port holds combined_score (int32 bits) and insert_size as int64."""
    j = _jit_pseudo(jscreens.PairCols(*(jnp.asarray(c) for c in cols)))
    t = screens_dev.pseudo_assembly_device(screens_dev.PairCols(
        *(torch.as_tensor(c.astype(np.int64) if k in (3, 7) else c)
          for k, c in enumerate(cols))))
    return t, j


@pytest.mark.parametrize("seed,p", [(0, 1), (1, 7), (2, 300), (3, 2000)])
def test_pseudo_assembly_device_equals_jax(seed, p):
    cols = _random_cols(seed, p)
    t, j = _both(cols)
    for name in screens_dev.PairCols._fields:
        np.testing.assert_array_equal(
            getattr(t, name).numpy().astype(np.int64),
            np.asarray(getattr(j, name)).astype(np.int64), err_msg=name)
    if p >= 300:
        # the data holds rescored chains, zero spans and 1-row chains
        perm, cseg = screens_dev.pseudo_assembly_chains(t)
        sizes = np.bincount(cseg.numpy())
        assert (sizes == 1).any() and sizes.max() > 10
        changed = t.combined_score.numpy() != cols[3].astype(np.int64)
        assert changed.sum() > p // 4
        assert (cols[6] == cols[5]).any()


def test_pseudo_assembly_device_saturates_like_jax():
    cols = _saturating_cols()
    t, j = _both(cols)
    got = t.combined_score.numpy()
    np.testing.assert_array_equal(got, np.asarray(j.combined_score))
    # 2^63 saturates to int64 max, whose low 32 bits read -1 as int32
    assert (got == -1).all()


@pytest.mark.parametrize("paired,pseudo", [(True, True), (True, False),
                                           (False, True)])
def test_phase_b_equals_jax(setup, paired, pseudo):  # noqa: F811
    taxdb, gindex, kidx, jdb, tdb, batch = setup
    ja, ta = _phase_a_both(setup, paired, packed=True)
    max_insert = min(_max_insert(ta), 2**32 - 1) if paired else 2**32 - 1
    mid = batch.midpoint if paired else 0
    jb = jdp.phase_b(ja, np.int32(mid), np.uint32(max_insert),
                     jnp.asarray(gindex.taxonomy_ids.astype(np.int32)),
                     jlca.build_device_tables(taxdb), fraction=0.95,
                     perform_pseudo_assembly=pseudo, paired=paired)
    tb = device_path.phase_b(
        ta, mid, max_insert,
        torch.as_tensor(gindex.taxonomy_ids.astype(np.int64)),
        lca.build_device_tables(taxdb, "cpu"), fraction=0.95,
        perform_pseudo_assembly=pseudo, paired=paired)
    t_rows, j_rows = _valid_rows(tb, True), _valid_rows(jb, False)
    assert len(t_rows[0]) > 0
    for a, b in zip(t_rows, j_rows):
        np.testing.assert_array_equal(a, b)
