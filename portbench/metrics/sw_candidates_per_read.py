"""Smith-Waterman candidates a read: the sw_candidates counts (the kept
overlaps match.compact_overlaps sends to SW) of the chunks whose feed
span starts in the traced window, over those feeds' reads counts (both
mates)."""

from portbench.program_spans import all_spans


def read(run):
    if run.trace is None or run.win is None:
        return None
    spans = all_spans()
    if not spans:
        return None
    lo, hi = run.win
    feeds = [s for s in spans if s.name == "feed"
             and lo <= run.trace.ts(s.start) < hi]
    reads = sum(f.counts.get("reads", 0) for f in feeds)
    if not reads:
        return None
    cands = sum(s.counts.get("sw_candidates", 0) for s in spans
                for f in feeds if s.role == "calling"
                and s.chunk == f.chunk and f.start <= s.start
                and s.end <= f.end)
    return cands / reads
