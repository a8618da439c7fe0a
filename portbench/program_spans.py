"""The program's own spans in a traced run's window.

kslam_tpu_torch keeps a span for each stage of each chunk while a
profiler is live on the thread that feeds its chunk pipeline
(utils/metrics.spans(): name, chunk, thread role, parent, start and end
on time.perf_counter(), the thread's CPU time, counts).  Here they are
put on the trace's clock by the harness's anchor (Trace.ts) and clipped
to the window.  A program that keeps no spans gives None.
"""

from __future__ import annotations

# the calling thread's stages that only launch device work and wait for
# it (phase_b's own time outside its phase_b_rescore child)
DEVICE_STAGES = ("phase_a_seed", "phase_a_sw", "phase_a_pair", "phase_b")


def all_spans():
    """Every span the program keeps, or None if it keeps none."""
    from kslam_tpu_torch.utils import metrics
    read = getattr(metrics, "spans", None)
    return read() if read is not None else None


def in_window(run):
    """[(start, end, span)] in trace microseconds, clipped to the window,
    of the spans that overlap it; None without a trace, a window or
    spans there."""
    if run.trace is None or run.win is None:
        return None
    spans = all_spans()
    if not spans:
        return None
    lo, hi = run.win
    out = []
    for s in spans:
        a, b = run.trace.ts(s.start), run.trace.ts(s.end)
        if b > lo and a < hi:
            out.append((max(a, lo), min(b, hi), s))
    return out or None


def seconds_per_mread(run, name: str):
    """Seconds of the `name` spans in the window, a million reads
    completed."""
    got = in_window(run)
    if got is None:
        return None
    return sum(b - a for a, b, s in got if s.name == name) / 1e6 / run.mreads


def union(intervals):
    """The sorted disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def minus(intervals, holes):
    """Disjoint sorted intervals less the union of `holes`."""
    holes = union(holes)
    out, j = [], 0
    for a, b in intervals:
        while j < len(holes) and holes[j][1] <= a:
            j += 1
        k = j
        while k < len(holes) and holes[k][0] < b:
            if holes[k][0] > a:
                out.append([a, holes[k][0]])
            a = max(a, holes[k][1])
            k += 1
        if b > a:
            out.append([a, b])
    return out


def exclusive(got, names):
    """The intervals in which the calling thread's innermost span is one
    of `names`: those spans less the spans nested in them."""
    calling = [(a, b, s) for a, b, s in got if s.role == "calling"]
    own = {s.id for _, _, s in calling if s.name in names}
    outer = union((a, b) for a, b, s in calling if s.id in own)
    inner = [(a, b) for a, b, s in calling if s.parent in own]
    return minus(outer, inner)
