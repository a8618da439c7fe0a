"""Smith-Waterman windows with the N runs the fused sw_align kernel
(csrc/sw_forward.cu) trims and skips, and the column extents it finds
while staging: the test data of chip_smoke.py and of the port's SW tests
(tests/test_torch_cuda.py, tests/test_torch_sw_group.py)."""

from __future__ import annotations

import numpy as np


def n_windows(rng, q, r):
    """Leading and trailing N runs on some ref rows, a middle N run,
    all-N refs and score-0 rows (a query of A against a ref without A),
    written into the int arrays q [B, Lq] and r [B, Lr]; returns them."""
    b, lr = r.shape
    lead = rng.integers(0, lr // 4 + 1, b)
    trail = rng.integers(0, lr // 4 + 1, b)
    j = np.arange(lr)[None, :]
    rows = np.arange(b)[:, None]
    r[(j < lead[:, None]) & (rows % 3 == 1)] = 4
    r[(j >= lr - trail[:, None]) & (rows % 4 == 2)] = 4
    r[1::6, lr // 2:lr // 2 + max(lr // 10, 1)] = 4
    r[2::7] = 4
    q[3::7] = 0
    r[3::7] = rng.integers(1, 4, r[3::7].shape)
    return q, r


def column_extents(r):
    """The first and last non-N column (c0, c1) of each row of r [B, L]
    (numpy), int64; (L, -1) for a row without one.  The fused kernel's
    forward pass sweeps c0..c1."""
    lr = r.shape[1]
    live = np.asarray(r) < 4
    has = live.any(1)
    c0 = np.where(has, live.argmax(1), lr).astype(np.int64)
    c1 = np.where(has, lr - 1 - live[:, ::-1].argmax(1), -1).astype(np.int64)
    return c0, c1
