"""Batched Smith-Waterman: the hand-written CUDA kernels
(csrc/sw_forward.cu) and their plain torch versions.

sw_forward_batch replaces kslam_tpu/ops/sw_pallas.py (`_sw_kernel` /
`_sw_kernel_body`, launched by `sw_forward_batch`): local alignment with
affine gaps, per row the score, the ref end column (-1 when the score is
0) and the query end row (0 when the score is 0), ties broken by the
smallest ref column, then the smallest query row, through the same packed
int32 key (h << 20) + ((1023 - j) << 10) + (1023 - i) - (2^20 - 1).

sw_align_batch replaces kslam_tpu/ops/sw_pallas.py:188-205 (forward
pass, reverse gather of the aligned prefixes, forward pass again: the
begin positions too) and, on the device pipeline, the flips and masks of
kslam_tpu/ops/sw.py:277-292, with one fused launch: the forward pass over
each window's non-N columns, then the reverse pass in the same thread
group from the same shared memory, over the aligned prefixes only.  Its
plain version is that composition over the forward pass's plain twin.

What bounds both on the H100: integer work.  A cell needs at least 8.5
int32 operations with Hopper's three-operand DPX max forms (score lookup,
h', H, two for F, two for E, a shift-add and half a three-way max for the
key); a pass over B = 32768
candidates of 160 x 192 cells is ~1e9 cells, while the bytes are only the
codes in and 12 (20) B per row out.  The kernel keeps the whole DP in
registers: a group of G threads per alignment, each holding R query rows,
sweeps the ref columns as a wavefront with the row above handed down by
warp shuffles (no device-memory scratch), scores a cell with one byte
permute of a per-column score word staged in shared memory, and updates
it with DPX max ops.  launch_config chooses G, R and the launch from the
shapes.

The wrappers send a CPU tensor to the plain version and a CUDA tensor to
the kernel; a CUDA tensor never falls back.  LAUNCHES counts kernel
launches of both kernels; ALIGN_LAUNCHES the fused ones; LAUNCH_CELLS
the rectangle cells of the work (B * Lq * Lr per forward launch,
2 * B * Lq * Lr per fused launch, whatever the trimmed kernel computes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cuda_lib import load_library
from .sw import SWAlignments, SWEnds, _reverse_gather

NEG = -(2 ** 30)
LAUNCHES = 0          # kernel launches (forward and fused)
ALIGN_LAUNCHES = 0    # of those, the fused sw_align_batch launches
LAUNCH_CELLS = 0      # rectangle cells of those launches

# Row counts per thread instantiated in csrc/sw_forward.cu
KERNEL_ROWS = (4, 8, 12, 16, 20, 24, 32)
MAX_THREADS = 128               # threads per block (kMaxThreads)
SMEM_BLOCK_LIMIT = 232_448      # shared memory one block may use (227 KB)
EXTENT_WORDS = 2                # fused kernel: c0, c1 beside the columns


class LaunchConfig(NamedTuple):
    group: int        # G threads per alignment (a power of two <= 32)
    rows: int         # R query rows per thread
    threads: int      # threads per block
    blocks: int       # grid size
    stride: int       # shared-memory words per alignment's columns (>= Lr)
    smem: int         # dynamic shared memory per block, bytes


def _config_for(b: int, lr: int, group: int, rows: int,
                align: bool = False) -> LaunchConfig:
    # stride = Lr rounded up to G mod 32 words, so that the alignments of
    # one warp read distinct banks at the same step; the fused kernel adds
    # two words per alignment (its first and last non-N column)
    stride = lr + (group - lr) % 32
    words = stride + (EXTENT_WORDS if align else 0)
    threads = MAX_THREADS
    # halve the block until its shared memory fits
    while threads > max(group, 32) and \
            (threads // group) * words * 4 > SMEM_BLOCK_LIMIT:
        threads //= 2
    per_block = threads // group
    return LaunchConfig(group, rows, threads, -(-b // per_block), stride,
                        per_block * words * 4)


def launch_config(b: int, lq: int, lr: int,
                  align: bool = False) -> LaunchConfig:
    """The kernel's launch for b alignments of lq x lr cells (align: the
    fused kernel): the smallest group G (a power of two) with
    32 * G >= lq, then the smallest R of KERNEL_ROWS with G * R >= lq
    (G = 8, R = 20 at the main path's lq = 160; G = 32, R = 32 at 1024),
    with the block cut until its shared memory fits."""
    if b < 1 or not 1 <= lq <= 1024 or not 1 <= lr <= 1024:
        raise ValueError(f"no SW kernel launch for B={b}, Lq={lq}, Lr={lr}")
    group = next(g for g in (1, 2, 4, 8, 16, 32) if 32 * g >= lq)
    rows = next(r for r in KERNEL_ROWS if group * r >= lq)
    return _config_for(b, lr, group, rows, align)


def _check_limits(lq: int, lr: int, match: int) -> None:
    if max(lq, lr) > 1024 or match * lq > 2047:
        raise ValueError(f"kernel limits exceeded: Lq={lq}, Lr={lr}, "
                         f"match={match}")


def sw_forward_batch_plain(q, r, match: int, mismatch: int, gap_open: int,
                           gap_extend: int, n_valid=None) -> SWEnds:
    """The kernel's plain torch twin: a column scan over the ref axis
    with F as an exact exclusive prefix max down the query axis (the
    reference package's ops/sw.py formulation).  Rows >= n_valid return
    (0, -1, 0), as the kernel writes them."""
    dev = q.device
    q = q.to(torch.int32)
    r = r.to(torch.int32)
    b, l = q.shape
    _check_limits(l, r.shape[1], match)
    go, ge = gap_open, gap_extend
    idx = torch.arange(l, dtype=torch.int32, device=dev)[None, :]
    q_n = q == 4
    zeros_col = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    neg_col = torch.full((b, 1), NEG, dtype=torch.int32, device=dev)
    h_prev = torch.zeros((b, l), dtype=torch.int32, device=dev)
    e_prev = torch.zeros((b, l), dtype=torch.int32, device=dev)
    best = torch.zeros(b, dtype=torch.int32, device=dev)
    best_col = torch.full((b,), -1, dtype=torch.int32, device=dev)
    best_h = torch.zeros((b, l), dtype=torch.int32, device=dev)
    for j in range(r.shape[1]):
        rj = r[:, j:j + 1]
        s = torch.where(q_n | (rj == 4), 0,
                        torch.where(q == rj, match, -mismatch))
        diag = torch.cat([zeros_col, h_prev[:, :-1]], dim=1)
        h = torch.clamp(diag + s, min=0)
        h = torch.maximum(h, e_prev)
        # exact lazy-F: F[i] = max_{k<i}(h[k] - go + k*ge) - (i-1)*ge
        a = h - go + idx * ge
        f = torch.cummax(torch.cat([neg_col, a[:, :-1]], dim=1),
                         dim=1).values - (idx - 1) * ge
        h = torch.maximum(h, f)
        e_prev = torch.clamp(torch.maximum(h - go, e_prev - ge), min=0)
        colmax = h.max(dim=1).values
        improved = colmax > best
        best = torch.where(improved, colmax, best)
        best_col = torch.where(improved, j, best_col)
        best_h = torch.where(improved[:, None], h, best_h)
        h_prev = h
    read_end = torch.argmax((best_h == best[:, None]).to(torch.int32),
                            dim=1).to(torch.int32)
    zero = best == 0
    score = best
    ref_end = torch.where(zero, -1, best_col)
    read_end = torch.where(zero, 0, read_end)
    if n_valid is not None:
        live = torch.arange(b, device=dev) < torch.as_tensor(
            n_valid, device=dev)
        score = torch.where(live, score, 0)
        ref_end = torch.where(live, ref_end, -1)
        read_end = torch.where(live, read_end, 0)
    return SWEnds(score, ref_end.to(torch.int32), read_end.to(torch.int32))


def _launch(q, r, match, mismatch, gap_open, gap_extend, n_valid,
            config: LaunchConfig | None = None, align: bool = False):
    """One launch of the forward kernel (SWEnds) or, with align, of the
    fused kernel (SWAlignments)."""
    global LAUNCHES, ALIGN_LAUNCHES, LAUNCH_CELLS
    dev = q.device
    b, lq = q.shape
    lr = r.shape[1]
    lib = load_library()
    # int32 codes, row-major: the callers' layout, so no copy on the path
    q = q.to(torch.int32).contiguous()
    r = r.to(torch.int32).contiguous()
    if n_valid is None:
        nv = torch.full((1,), b, dtype=torch.int32, device=dev)
    else:
        nv = torch.as_tensor(n_valid, device=dev).to(torch.int32).reshape(1)
    n_out = 5 if align else 3
    out = torch.empty((n_out, b), dtype=torch.int32, device=dev)
    cfg = config or launch_config(b, lq, lr, align=align)
    for t, shape, dt in ((r, (b, lr), torch.int32), (nv, (1,), torch.int32),
                         (out, (n_out, b), torch.int32)):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"SW kernel operand mismatch: {t.device} "
                             f"{t.dtype} {tuple(t.shape)}, want {dev} {dt} "
                             f"{shape} contiguous")
    stream = torch.cuda.current_stream(dev).cuda_stream
    entry = lib.kslam_sw_align if align else lib.kslam_sw_forward
    err = entry(
        q.data_ptr(), r.data_ptr(), nv.data_ptr(), out.data_ptr(), b, lq, lr,
        cfg.group, cfg.rows, cfg.stride, cfg.threads,
        cfg.blocks, cfg.smem, match, mismatch, gap_open, gap_extend,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        stream)
    if err != 0:
        raise RuntimeError(f"SW kernel launch failed: cudaError {err} "
                           f"({cfg})")
    LAUNCHES += 1
    if align:
        ALIGN_LAUNCHES += 1
        LAUNCH_CELLS += 2 * b * lq * lr
        return SWAlignments(*out)
    LAUNCH_CELLS += b * lq * lr
    return SWEnds(out[0], out[1], out[2])


def _check_inputs(q, r, match: int) -> None:
    if q.dim() != 2 or r.dim() != 2 or q.shape[0] != r.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} and r {tuple(r.shape)} must "
                         f"be [B, Lq] and [B, Lr]")
    if q.device != r.device:
        raise ValueError(f"q on {q.device}, r on {r.device}")
    if q.dtype.is_floating_point or r.dtype.is_floating_point:
        raise ValueError("q and r must hold integer codes 0..4")
    _check_limits(q.shape[1], r.shape[1], match)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no SW kernel for device {q.device}")


def sw_forward_batch(q, r, match: int, mismatch: int, gap_open: int,
                     gap_extend: int, n_valid=None) -> SWEnds:
    """Forward pass over q [B, Lq] and r [B, Lr] code tensors (Lr may
    exceed Lq).  n_valid (int or device scalar): rows >= n_valid return
    (0, -1, 0) without running the DP; the kernel reads it on the device,
    with no host sync.  CPU tensors run the plain twin; CUDA tensors the
    kernel."""
    _check_inputs(q, r, match)
    if q.device.type == "cpu":
        return sw_forward_batch_plain(q, r, match, mismatch, gap_open,
                                      gap_extend, n_valid=n_valid)
    if q.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int32, device=q.device)
        return SWEnds(z, z, z)
    return _launch(q, r, match, mismatch, gap_open, gap_extend, n_valid)


def _align_composition(forward, q, r, match: int, mismatch: int,
                       gap_open: int, gap_extend: int,
                       n_valid=None) -> SWAlignments:
    """Forward pass, reverse gather of the aligned prefixes, forward pass
    again: scores, end and begin positions (sw_pallas.sw_align_batch).
    Rows >= n_valid give (0, -1, -1, 0, 0)."""
    fwd = forward(q, r, match, mismatch, gap_open, gap_extend,
                  n_valid=n_valid)
    q_rev = _reverse_gather(q, fwd.read_end)
    r_rev = _reverse_gather(r, fwd.ref_end)
    rev = forward(q_rev, r_rev, match, mismatch, gap_open, gap_extend,
                  n_valid=n_valid)
    zero = fwd.score == 0
    ref_begin = torch.where(zero, -1, fwd.ref_end - rev.ref_end)
    query_begin = torch.where(zero, 0, fwd.read_end - rev.read_end)
    return SWAlignments(fwd.score, ref_begin.to(torch.int32), fwd.ref_end,
                        query_begin.to(torch.int32), fwd.read_end)


def sw_align_batch(q, r, match: int, mismatch: int, gap_open: int,
                   gap_extend: int, n_valid=None) -> SWAlignments:
    """Scores, begin and end positions over q [B, Lq] and r [B, Lr]
    (window coordinates; counterpart of sw_pallas.sw_align_batch): one
    launch of the fused kernel for CUDA tensors, the plain composition
    for CPU ones.  n_valid as for sw_forward_batch; rows >= n_valid give
    (0, -1, -1, 0, 0)."""
    _check_inputs(q, r, match)
    if q.device.type == "cpu":
        return sw_align_batch_plain(q, r, match, mismatch, gap_open,
                                    gap_extend, n_valid=n_valid)
    if q.shape[0] == 0:
        z = torch.zeros(0, dtype=torch.int32, device=q.device)
        return SWAlignments(z, z, z, z, z)
    return _launch(q, r, match, mismatch, gap_open, gap_extend, n_valid,
                   align=True)


def sw_align_batch_plain(q, r, match: int, mismatch: int, gap_open: int,
                         gap_extend: int, n_valid=None) -> SWAlignments:
    """The fused kernel's plain version: the composition over the forward
    pass's plain twin, on any device."""
    return _align_composition(sw_forward_batch_plain, q, r, match, mismatch,
                              gap_open, gap_extend, n_valid=n_valid)
