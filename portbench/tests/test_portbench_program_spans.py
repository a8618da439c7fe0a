"""The readers of the program's own spans (program_spans.py and the six
metrics that use it): a traced tiny run reads each as a number, and a
span mapped through the harness's anchor lands on its own kslam.* event
in the profiler's trace."""

import json
import types

import pytest

from portbench import program_spans, registry
from portbench import trace as trace_mod
from portbench.tests.harness import tiny_run
from kslam_tpu_torch.utils import metrics

NEW = ("reader_wait_s_per_mread", "reader_off_cpu_pct",
       "tail_wait_s_per_mread", "phase_b_rescore_s_per_mread",
       "idle_dispatch_pct", "sw_candidates_per_read")


@pytest.fixture(scope="module")
def traced():
    """A traced tiny run: (result line, its Trace, keeping the trace's
    events)."""
    kept = []

    class Keeping(trace_mod.Trace):
        def __init__(self, path, *args):
            with open(path) as fh:
                self.events = json.load(fh)["traceEvents"]
            super().__init__(path, *args)
            kept.append(self)
    metrics.reset()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trace_mod, "Trace", Keeping)
        res = tiny_run(seed=2**31 + 12345, traffic="host-rich",
                       seconds=2.0, trace=1)
    return res, kept[0]


def test_traced_run_reads_every_new_metric(traced):
    res, _ = traced
    assert res["correct"] is True
    names = {m["name"] for m in registry.benchmark()["per_layer"]}
    assert set(NEW) <= names
    for name in NEW:
        value = res["metrics"][name]["value"]
        assert isinstance(value, float), (name, value)
        assert value >= 0.0, (name, value)
    assert res["metrics"]["reader_off_cpu_pct"]["value"] <= 100.0
    assert res["metrics"]["idle_dispatch_pct"]["value"] <= 100.0
    assert res["metrics"]["sw_candidates_per_read"]["value"] > 0.0


def test_span_lands_on_its_profiler_event(traced):
    """Each calling-thread kslam.feed event of the window's trace starts
    within 2 ms of its program span mapped through the anchor."""
    _, trace = traced
    anchor = [e for e in trace.events
              if e.get("name") == "portbench.anchor"]
    tid = anchor[0]["tid"]
    events = sorted(float(e["ts"]) for e in trace.events
                    if e.get("name") == "kslam.feed"
                    and e.get("tid") == tid)
    lo, hi = anchor[0]["ts"], events[-1] + 2000.0
    feeds = sorted(trace.ts(s.start) for s in metrics.spans()
                   if s.name == "feed" and lo <= trace.ts(s.start) <= hi)
    assert len(events) >= 3 and len(events) == len(feeds)
    for ev, sp in zip(events, feeds):
        assert abs(ev - sp) < 2000.0, (ev, sp)


def test_no_trace_or_no_spans_reads_none(monkeypatch):
    run = types.SimpleNamespace(trace=None, win=None, mreads=1.0)
    for name in NEW:
        assert registry.reader(name)(run) is None
    # a program that keeps no spans
    monkeypatch.delattr(metrics, "spans")
    run = types.SimpleNamespace(trace=types.SimpleNamespace(
        ts=lambda t: t * 1e6, device=[]), win=(0.0, 1e6), mreads=1.0)
    for name in NEW:
        assert registry.reader(name)(run) is None


def test_idle_dispatch_is_idle_time_in_a_device_stage_alone():
    """A phase_b span of 0-10 us holding a phase_b_rescore of 4-6 us, a
    phase_a_sw of 12-20 us, a feed of 0-30 us around them; the card
    busy 2-8 and 14-15 us: the card idles in a device stage 0-2, 8-10,
    12-14 and 15-20 (the rescore's 4-6 is host work)."""
    def span(i, name, a, b, parent=None):
        return metrics.Span(i, name, 0, "calling", parent, a, b)
    spans = [span(1, "feed", 0, 30), span(2, "phase_b", 0, 10, 1),
             span(3, "phase_b_rescore", 4, 6, 2),
             span(4, "phase_a_sw", 12, 20, 1),
             metrics.Span(5, "phase_a_sw", 0, "reader", None, 20, 30)]
    run = types.SimpleNamespace(
        trace=types.SimpleNamespace(
            ts=lambda t: t, device=[(2, 8, "k"), (14, 15, "k")]),
        win=(0.0, 30.0), mreads=1.0)
    excl = program_spans.exclusive([(s.start, s.end, s) for s in spans],
                                   program_spans.DEVICE_STAGES)
    assert excl == [[0, 4], [6, 10], [12, 20]]
    idle = program_spans.minus(excl, [(2, 8), (14, 15)])
    assert idle == [[0, 2], [8, 10], [12, 14], [15, 20]]
    read = registry.reader("idle_dispatch_pct")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(metrics, "spans", lambda: spans)
        assert read(run) == pytest.approx(100.0 * 11 / 30)
