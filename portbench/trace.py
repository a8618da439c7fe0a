"""Reduction of a torch.profiler chrome trace to the device's busy time,
kernel times by name, the top device operations and the longest idle
gaps, over the window.

Device intervals are the trace's CUDA kernel, memcpy and memset events
of every stream.  The host side is the harness's own record of its calls
into the program (window.Window.spans: kind, chunk, start, end on the
host clock), put on the trace's clock by one anchor: the
"portbench.anchor" record_function span the calling thread opens as the
profiler starts, at a known host time.
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    def __init__(self, path: str, anchor_t: float, host_spans):
        """anchor_t: the host time (time.perf_counter) at which the
        anchor span opened; host_spans: [(kind, chunk, start, end)] on
        the host clock."""
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
        ops = [e for e in events
               if e.get("cat") in DEVICE_CATS and "ts" in e]
        self.device = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e.get("name", "")) for e in ops)
        cards = {}
        for e in ops:
            cards.setdefault(e.get("args", {}).get("device", 0), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))))
        self.cards = [sorted(v) for v in cards.values()]
        anchors = [float(e["ts"]) for e in events
                   if e.get("name") == "portbench.anchor"
                   and e.get("cat") == "user_annotation" and "ts" in e]
        names = {e.get("name") for e in events
                 if e.get("cat") == "user_annotation"}
        self.found = (f"{len(self.device)} device intervals, "
                      f"{len(anchors)} anchor spans, {len(names)} span "
                      f"names: {sorted(map(str, names))[:6]}")
        self.offset = anchors[0] - anchor_t * 1e6 if anchors else None
        self.spans = [] if self.offset is None else sorted(
            (self.ts(a), self.ts(b), f"portbench.{kind}#{no}")
            for kind, no, a, b in host_spans)
        self._starts = [d[0] for d in self.device]

    def ts(self, t: float) -> float:
        """A host time on the trace's clock (microseconds)."""
        return t * 1e6 + self.offset

    def _in(self, lo, hi):
        i = bisect.bisect_left(self._starts, lo)
        j = bisect.bisect_left(self._starts, hi)
        return self.device[i:j]

    def busy_s(self, lo: float, hi: float) -> float:
        """Seconds of [lo, hi) in which some operation ran on a card (the
        union of its intervals, clipped to the window), averaged over
        the cards the trace holds."""
        if not self.cards:
            return 0.0
        total = 0.0
        for ivs in self.cards:
            busy, end = 0.0, lo
            i = max(bisect.bisect_left(ivs, (lo,)) - 1, 0)
            for a, b in ivs[i:]:
                if a >= hi:
                    break
                a, b = max(a, end), min(b, hi)
                if b > a:
                    busy += b - a
                    end = b
            total += busy
        return total / len(self.cards) / 1e6

    def kernels(self, part: str, lo: float, hi: float):
        """(start, duration s) of the kernels whose name holds `part` and
        that start in [lo, hi)."""
        return [(a, (b - a) / 1e6) for a, b, n in self._in(lo, hi)
                if part in n]

    def top_ops(self, lo: float, hi: float, n: int = 10):
        tot = {}
        for a, b, name in self._in(lo, hi):
            key = short(name)
            tot[key] = tot.get(key, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in tot.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, lo: float, hi: float, n: int = 10):
        """The n longest gaps in [lo, hi) with no device operation, each
        named by the harness spans open on the host at its middle."""
        gaps, end = [], lo
        for a, b, _ in self._in(lo, hi):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            open_ = sorted({s[2].split("#")[0][len("portbench."):]
                            for s in self.spans if s[0] <= mid < s[1]})
            out.append(["host: " + ("+".join(open_) or "no span"),
                        (b - a) / 1e6])
        return out


def short(name: str) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0] or name


def chunk_of(trace: Trace, kind: str, ts: float):
    """The chunk number of the `kind` span ("feed", "tail") holding ts."""
    for a, b, name in trace.spans:
        if a <= ts < b and name.startswith(f"portbench.{kind}#"):
            return int(name.split("#")[1])
    return None
