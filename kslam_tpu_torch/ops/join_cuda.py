"""Launch glue of the join's hand-written kernels (csrc/join.cu):
sector_join (the port's one-sector table, db/sector_table.py, standing
for kslam_tpu/ops/join.py:146-191, lookup_bucket), bucket_join (the
same lookup on the reference's 64 B bucket table) and window_join
(kslam_tpu/ops/join.py:244-288, lookup_prefix_window).  ops/join.py's
public lookups check their operands here, send a CPU tensor to the
plain version and a CUDA tensor to these launches, which check them and
raise for any other device; a CUDA tensor never falls back.

Each kernel has two modes.  sector_join / bucket_join / window_join are
the lookups: (lo, hi, uncovered).  The *_join_bounds functions are
ops/match.join_bounds on the card: the same launch also resolves every
kept (q_ok) query its table leaves uncovered with an exact search of the
run the table gives, so it returns only (lo, hi), exact wherever q_ok,
equal to join_bounds' plain version (lookup, nonzero, searchsorted_both,
index_put) on every query, without a host synchronisation.

Each launch goes on the current stream of the queries' device without a
synchronisation, into outputs made with torch.empty (lo, hi int64 and
uncovered int32, shaped like the queries); the C entry point restores
the caller's current device, and a non-zero cudaError raises.
JOIN_LAUNCHES counts the launches of each kernel, in either mode; zero
queries launch nothing.
"""

from __future__ import annotations

import torch

from .cuda_lib import load_library

JOIN_LAUNCHES = {"sector_join": 0, "bucket_join": 0, "window_join": 0}

SLOTS = 8             # slots of a bucket row (KmerIndex.BUCKET_SLOTS)
DELTA_BITS = 12       # bits of a slot's t-delta (KmerIndex.BUCKET_DELTA_BITS)
THREADS = 256         # threads per block (kMaxThreads in join.cu)
MAX_BLOCKS = 1 << 20  # the grid-stride loops cover more queries
TABLE_ALIGN = 64      # a bucket row is two 32 B sectors
SECTOR_ALIGN = 32     # a sector row is one
MAX_WINDOW = 4096     # a covered run (<= 2w keys) is scanned in full


def launch_config(n: int):
    """(threads, blocks) of either kernel's launch over n queries: one
    thread per query, the grid capped at MAX_BLOCKS (grid-stride)."""
    return THREADS, max(min(-(-n // THREADS), MAX_BLOCKS), 1)


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


def check_sector(tbl, queries, bits: int, aligned: bool = False) -> None:
    """Raises ValueError unless tbl is a contiguous int32 [2^bits, 8]
    sector table and queries contiguous int64 keys on tbl's device;
    aligned: the table's rows are also 32 B aligned, one sector each, as
    the kernel reads them."""
    if not 1 <= bits <= 32:
        raise ValueError(f"sector bits {bits} not in 1..32")
    _check("tbl", tbl, torch.int32, shape=(1 << bits, 8))
    _check("queries", queries, torch.int64)
    _check_device(queries, tbl)
    if aligned:
        _check_aligned("tbl", tbl, SECTOR_ALIGN)


def check_window(index_kmers, pstart, queries, prefix_bits: int,
                 window: int) -> None:
    """Raises ValueError unless index_kmers is 1-d contiguous int64 whose
    length is a multiple of window and >= 2 * window, pstart contiguous
    int32 [2^prefix_bits + 1], queries contiguous int64, all on one
    device, and window a power of two in 2..MAX_WINDOW."""
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


def check_tier2(index_kmers, q_ok, queries) -> None:
    """Raises ValueError unless index_kmers is 1-d contiguous int64 with
    at least one key and q_ok a contiguous bool mask shaped like the
    queries, both on the queries' device."""
    _check("index_kmers", index_kmers, torch.int64, dims=1)
    if index_kmers.shape[0] < 1:
        raise ValueError("join operand index_kmers: no keys")
    _check("q_ok", q_ok, torch.bool, shape=tuple(queries.shape))
    _check_device(queries, index_kmers, q_ok)


def _outputs(queries, uncovered: bool = True):
    dev = queries.device
    lo = torch.empty(queries.shape, dtype=torch.int64, device=dev)
    hi = torch.empty(queries.shape, dtype=torch.int64, device=dev)
    if not uncovered:
        return lo, hi
    return lo, hi, torch.empty(queries.shape, dtype=torch.int32, device=dev)


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


def _row_launch(name: str, tbl, queries, bits: int, index_kmers=None,
                q_ok=None):
    """One launch of the sector_join or bucket_join kernel (their C
    entry points take the same arguments)."""
    index, stream = _device_and_stream(queries)
    if name == "sector_join":
        check_sector(tbl, queries, bits, aligned=True)
    else:
        check_bucket(tbl, queries, bits, aligned=True)
    if q_ok is not None:
        check_tier2(index_kmers, q_ok, queries)
    out = _outputs(queries, uncovered=q_ok is None)
    n = queries.numel()
    if n == 0:
        return out
    threads, blocks = launch_config(n)
    err = getattr(load_library(), f"kslam_{name}")(
        queries.data_ptr(), tbl.data_ptr(),
        None if q_ok is None else index_kmers.data_ptr(),
        0 if q_ok is None else index_kmers.shape[0],
        None if q_ok is None else q_ok.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(),
        None if q_ok is not None else out[2].data_ptr(),
        n, bits, threads, blocks, index, stream)
    _raise_on(err, name, n)
    JOIN_LAUNCHES[name] += 1
    return out


def _window_launch(index_kmers, pstart, queries, prefix_bits: int,
                   window: int, q_ok=None):
    index, stream = _device_and_stream(queries)
    check_window(index_kmers, pstart, queries, prefix_bits, window)
    if q_ok is not None:
        check_tier2(index_kmers, q_ok, queries)
    out = _outputs(queries, uncovered=q_ok is None)
    n = queries.numel()
    if n == 0:
        return out
    threads, blocks = launch_config(n)
    err = load_library().kslam_window_join(
        index_kmers.data_ptr(), index_kmers.shape[0], pstart.data_ptr(),
        queries.data_ptr(), None if q_ok is None else q_ok.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(),
        None if q_ok is not None else out[2].data_ptr(),
        n, prefix_bits, window, threads, blocks, index, stream)
    _raise_on(err, "window_join", n)
    JOIN_LAUNCHES["window_join"] += 1
    return out


def sector_join(tbl, queries, bits: int):
    """(lo, hi, uncovered) of lookup_sector from one launch of the
    sector_join kernel; CUDA tensors only."""
    return _row_launch("sector_join", tbl, queries, bits)


def sector_join_bounds(tbl, queries, bits: int, index_kmers, q_ok):
    """(lo, hi) of match.join_bounds with the sector table from one
    launch of the sector_join kernel, tier 2 included: index_kmers are
    the sorted, sentinel-padded keys the table was built from; CUDA
    tensors only."""
    return _row_launch("sector_join", tbl, queries, bits, index_kmers,
                       q_ok)


def bucket_join(tbl, queries, bits: int):
    """(lo, hi, uncovered) of lookup_bucket from one launch of the
    bucket_join kernel; CUDA tensors only."""
    return _row_launch("bucket_join", tbl, queries, bits)


def bucket_join_bounds(tbl, queries, bits: int, index_kmers, q_ok):
    """(lo, hi) of match.join_bounds with the bucket table from one
    launch of the bucket_join kernel, tier 2 included: index_kmers are
    the sorted, sentinel-padded keys the table was built from; CUDA
    tensors only."""
    return _row_launch("bucket_join", tbl, queries, bits, index_kmers,
                       q_ok)


def window_join(index_kmers, pstart, queries, prefix_bits: int,
                window: int):
    """(lo, hi, uncovered) of lookup_prefix_window from one launch of
    the window_join kernel; CUDA tensors only."""
    return _window_launch(index_kmers, pstart, queries, prefix_bits, window)


def window_join_bounds(index_kmers, pstart, queries, prefix_bits: int,
                       window: int, q_ok):
    """(lo, hi) of match.join_bounds with the prefix window from one
    launch of the window_join kernel, tier 2 included; CUDA tensors
    only."""
    return _window_launch(index_kmers, pstart, queries, prefix_bits, window,
                          q_ok)
