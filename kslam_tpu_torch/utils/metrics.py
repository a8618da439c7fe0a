"""Per-stage timing, counters and spans.

The structured successor of the reference's count-logging (its Log lines
record reads parsed, k-mers, overlaps found/screened, insert-size stats --
sequenceTools.h:154-179 callers).  Here every pipeline stage records wall
time and item counts into a process-global registry; `summary()` derives
reads/sec.

Spans: while a torch profiler is live on the thread that feeds the chunk
pipeline (pipeline/run.ChunkPipeline.feed), each stage() of a chunk's
work, on whichever thread runs it (reader, calling or tail), also keeps a
Span in a bounded ring (spans()), on time.perf_counter() with the
thread's time.thread_time(), and opens a torch.profiler.record_function
"kslam.<name>" while a profiler is live (it records those of the threads
it runs on, or of every thread with profile_all_threads).  A thread traces
only inside traced(), which the pipeline opens around each chunk's job;
elsewhere stage() keeps its aggregate timer only.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from .logging import log

RING_SPANS = 1 << 16


@dataclasses.dataclass
class StageStats:
    calls: int = 0
    seconds: float = 0.0
    items: int = 0


@dataclasses.dataclass
class Span:
    """One stage of one chunk on one thread.  start/end: the stage's
    timer (time.perf_counter()); cpu_start/cpu_end: the thread's
    time.thread_time() around it; parent: the id of the enclosing span on
    the thread, or for a job's root span the span that handed the job
    on (None for the calling thread's roots); counts: count()s made
    while this was the thread's innermost span."""
    id: int
    name: str
    chunk: int
    role: str                    # "calling", "reader" or "tail"
    parent: Optional[int]
    start: float = 0.0
    end: float = 0.0
    cpu_start: float = 0.0
    cpu_end: float = 0.0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class _Job:
    """A thread's tracing state while it runs one chunk's job."""
    __slots__ = ("chunk", "role", "parent", "open")

    def __init__(self, chunk: int, role: str, parent: Optional[int]):
        self.chunk, self.role, self.parent = chunk, role, parent
        self.open: List[Span] = []


_STAGES: Dict[str, StageStats] = {}
_COUNTERS: Dict[str, int] = {}
_SPANS: collections.deque = collections.deque(maxlen=RING_SPANS)
_LOCK = threading.Lock()
_IDS = itertools.count(1)
_local = threading.local()


def reset() -> None:
    with _LOCK:
        _STAGES.clear()
        _COUNTERS.clear()
        _SPANS.clear()


def profiler_live() -> bool:
    """Whether a torch profiler is live: one started on this thread (the
    thread-local flag), or one with profile_all_threads, which records
    every thread while that flag reads False on each of them."""
    return torch._C._autograd._profiler_enabled() or getattr(
        torch.autograd.profiler, "_is_profiler_enabled", False)


def handoff(chunk: int) -> Optional[Tuple[int, Optional[int]]]:
    """The origin of a job on `chunk` that this thread hands on: (chunk,
    the id of this thread's innermost open span); None where this thread
    is not tracing."""
    job = getattr(_local, "job", None)
    if job is None:
        return None
    return chunk, job.open[-1].id if job.open else job.parent


@contextlib.contextmanager
def traced(role: str, origin):
    """The block's stages record spans of origin's chunk, in `role`, with
    origin's span as their root's parent.  origin: handoff()'s, or
    (chunk, None) for a root on the calling thread; None traces
    nothing."""
    if origin is None:
        yield
        return
    prev = getattr(_local, "job", None)
    _local.job = _Job(origin[0], role, origin[1])
    try:
        yield
    finally:
        _local.job = prev


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name`, and while tracing to the innermost
    open span's counts."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n
    job = getattr(_local, "job", None)
    if job is not None and job.open:
        counts = job.open[-1].counts
        counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def stage(name: str, items: int = 0):
    """Times a pipeline stage; `items` feeds the per-stage rate.  While
    tracing, also a span (and a record_function while a profiler is
    live) over the same interval."""
    job = getattr(_local, "job", None)
    span = rf = None
    if job is not None:
        span = Span(next(_IDS), name, job.chunk, job.role,
                    job.open[-1].id if job.open else job.parent,
                    cpu_start=time.thread_time())
        job.open.append(span)
        if profiler_live():
            rf = record_function(f"kslam.{name}")
            rf.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        if span is not None:
            if rf is not None:
                rf.__exit__(None, None, None)
            span.start, span.end = t0, t1
            span.cpu_end = time.thread_time()
            job.open.pop()
        with _LOCK:
            s = _STAGES.get(name)
            if s is None:
                s = _STAGES[name] = StageStats()
            s.calls += 1
            s.seconds += t1 - t0
            s.items += items
            if span is not None:
                _SPANS.append(span)


def spans() -> List[Span]:
    """The spans kept, oldest first (the last RING_SPANS closed)."""
    with _LOCK:
        return list(_SPANS)


def counters() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTERS)


def summary() -> Dict[str, dict]:
    out: Dict[str, dict] = {}
    with _LOCK:
        stages = list(_STAGES.items())
    for name, s in stages:
        entry = {"calls": s.calls, "seconds": round(s.seconds, 4)}
        if s.items:
            entry["items"] = s.items
            entry["items_per_sec"] = round(s.items / s.seconds, 1) \
                if s.seconds else None
        out[name] = entry
    got = counters()
    if got:
        out["counters"] = got
    return out


def log_summary() -> None:
    for name, entry in summary().items():
        log(f"stage {name}: {entry}")
