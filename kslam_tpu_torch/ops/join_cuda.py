"""Launch glue of the join's hand-written kernels (csrc/join.cu):
bucket_join (the counterpart of kslam_tpu/ops/join.py:146-191,
lookup_bucket) and window_join (kslam_tpu/ops/join.py:244-288,
lookup_prefix_window).  ops/join.py's public lookups check their
operands here, send a CPU tensor to the plain version and a CUDA tensor
to these launches, which check them and raise for any other device; a
CUDA tensor never falls back.

Each launch goes on the current stream of the queries' device without a
synchronisation, into outputs made with torch.empty (lo, hi int64 and
uncovered int32, shaped like the queries); the C entry point restores
the caller's current device, and a non-zero cudaError raises.
JOIN_LAUNCHES counts the launches of each kernel; zero queries launch
nothing.
"""

from __future__ import annotations

import torch

from .cuda_lib import load_library

JOIN_LAUNCHES = {"bucket_join": 0, "window_join": 0}

SLOTS = 8             # slots of a bucket row (KmerIndex.BUCKET_SLOTS)
DELTA_BITS = 12       # bits of a slot's t-delta (KmerIndex.BUCKET_DELTA_BITS)
THREADS = 256         # threads per block (kMaxThreads in join.cu)
MAX_BLOCKS = 1 << 20  # the grid-stride loops cover more queries
TABLE_ALIGN = 64      # a bucket row is two 32 B sectors
KEYS_ALIGN = 16       # the window's keys are read as 16 B pairs
MAX_WINDOW = 4096     # lt | eq << 16 holds counts of 2w <= 2^13 slots


def launch_config(n: int, window: int = 0):
    """(group, threads, blocks) of a launch over n queries: window 0 is
    bucket_join (one thread per query), else window_join with a group of
    min(window, 32) lanes per query and 32 / group queries per warp."""
    group = min(window, 32) if window else 1
    per_block = THREADS // group
    return group, THREADS, max(min(-(-n // per_block), MAX_BLOCKS), 1)


def _check(name, t, dtype, shape=None, dims=None):
    if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape) \
            or (dims is not None and t.dim() != dims) \
            or not t.is_contiguous():
        want = shape if shape is not None else f"{dims}-d"
        raise ValueError(f"join operand {name}: {t.dtype} "
                         f"{tuple(t.shape)} contiguous={t.is_contiguous()}, "
                         f"want {dtype} {want} contiguous")


def _check_device(queries, *others) -> None:
    for t in others:
        if t.device != queries.device:
            raise ValueError(f"join operands on {t.device} and "
                             f"{queries.device}")


def _check_aligned(name, t, align: int) -> None:
    if t.data_ptr() % align:
        raise ValueError(f"join operand {name} at {t.data_ptr():#x} is not "
                         f"{align} B aligned")


def check_bucket(tbl, queries, bits: int, aligned: bool = False) -> None:
    """Raises ValueError unless tbl is a contiguous int32 [2^bits, 16]
    table and queries contiguous int64 keys on tbl's device; aligned: the
    table's rows are also 64 B aligned, as the kernel reads them."""
    if not 1 <= bits <= 32:
        raise ValueError(f"bucket bits {bits} not in 1..32")
    _check("tbl", tbl, torch.int32, shape=(1 << bits, 16))
    _check("queries", queries, torch.int64)
    _check_device(queries, tbl)
    if aligned:
        _check_aligned("tbl", tbl, TABLE_ALIGN)


def check_window(index_kmers, pstart, queries, prefix_bits: int,
                 window: int, aligned: bool = False) -> None:
    """Raises ValueError unless index_kmers is 1-d contiguous int64 whose
    length is a multiple of window and >= 2 * window, pstart contiguous
    int32 [2^prefix_bits + 1], queries contiguous int64, all on one
    device, and window a power of two in 2..MAX_WINDOW;
    aligned: the keys are also 16 B aligned, as the kernel reads them."""
    if window < 2 or window > MAX_WINDOW or window & (window - 1):
        raise ValueError(f"window {window} is not a power of two in "
                         f"2..{MAX_WINDOW}")
    if not 1 <= prefix_bits <= 31:
        raise ValueError(f"prefix bits {prefix_bits} not in 1..31")
    _check("index_kmers", index_kmers, torch.int64, dims=1)
    n_keys = index_kmers.shape[0]
    if n_keys % window or n_keys < 2 * window:
        raise ValueError(f"{n_keys} index keys: not a multiple of the "
                         f"window {window} with two rows or more")
    _check("pstart", pstart, torch.int32, shape=((1 << prefix_bits) + 1,))
    _check("queries", queries, torch.int64)
    _check_device(queries, index_kmers, pstart)
    if aligned:
        _check_aligned("index_kmers", index_kmers, KEYS_ALIGN)


def _outputs(queries):
    dev = queries.device
    return (torch.empty(queries.shape, dtype=torch.int64, device=dev),
            torch.empty(queries.shape, dtype=torch.int64, device=dev),
            torch.empty(queries.shape, dtype=torch.int32, device=dev))


def _device_and_stream(queries):
    dev = queries.device
    if dev.type != "cuda":
        raise ValueError(f"no join kernel for device {dev}")
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    return index, torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, name: str, n: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err} "
                           f"({n} queries)")


def bucket_join(tbl, queries, bits: int):
    """(lo, hi, uncovered) of lookup_bucket from one launch of the
    bucket_join kernel; CUDA tensors only."""
    index, stream = _device_and_stream(queries)
    check_bucket(tbl, queries, bits, aligned=True)
    lo, hi, unc = _outputs(queries)
    n = queries.numel()
    if n == 0:
        return lo, hi, unc
    _, threads, blocks = launch_config(n)
    err = load_library().kslam_bucket_join(
        queries.data_ptr(), tbl.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        unc.data_ptr(), n, bits, threads, blocks, index, stream)
    _raise_on(err, "bucket_join", n)
    JOIN_LAUNCHES["bucket_join"] += 1
    return lo, hi, unc


def window_join(index_kmers, pstart, queries, prefix_bits: int,
                window: int):
    """(lo, hi, uncovered) of lookup_prefix_window from one launch of
    the window_join kernel; CUDA tensors only."""
    index, stream = _device_and_stream(queries)
    check_window(index_kmers, pstart, queries, prefix_bits, window,
                 aligned=True)
    lo, hi, unc = _outputs(queries)
    n = queries.numel()
    if n == 0:
        return lo, hi, unc
    group, threads, blocks = launch_config(n, window)
    err = load_library().kslam_window_join(
        index_kmers.data_ptr(), index_kmers.shape[0], pstart.data_ptr(),
        queries.data_ptr(), lo.data_ptr(), hi.data_ptr(), unc.data_ptr(),
        n, prefix_bits, window, group, threads, blocks, index, stream)
    _raise_on(err, "window_join", n)
    JOIN_LAUNCHES["window_join"] += 1
    return lo, hi, unc
