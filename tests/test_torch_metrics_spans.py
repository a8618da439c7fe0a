"""The spans of kslam_tpu_torch's stage timers (utils/metrics.py).

Without a profiler no span is kept and no record_function is opened;
tracing leaves the aggregate timers as they are; under a profiler every
span of a chunk carries its chunk on the reader, calling and tail
threads at depth 3 and 1, parents nest and the waits sit on the calling
thread; counts go to the innermost span; the ring is bounded; threads
lose no update.  The port's CLI on the CPU, traced, keeps the counts
and stages the benchmark's readers read, and writes what it writes
untraced."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from kslam_tpu_torch import cli as tcli
from kslam_tpu_torch.config import PipelineConfig
from kslam_tpu_torch.io.fastq import ReadBatch
from kslam_tpu_torch.ops import screen as screen_ops
from kslam_tpu_torch.pipeline import run as trun
from kslam_tpu_torch.utils import metrics
from tests import torch_cli_fixtures as fx

N_CHUNKS = 6


@pytest.fixture(autouse=True)
def fresh_registry():
    metrics.reset()
    yield
    metrics.reset()


def profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def stub_chunks(n):
    for k in range(n):
        yield ReadBatch([f"q{k}", f"r{k}"], np.full((2, 40), 65, np.uint8),
                        np.array([40, 40], np.int32),
                        np.zeros((2, 40), np.uint8), paired=False)


def drive(depth, monkeypatch, tail_delay=0.0):
    """N_CHUNKS two-read chunks through ChunkPipeline with stub device
    work (a phase_a stage counting 3 candidates a read) and a stub tail
    (a taxonomy stage), prepared by the real low-complexity flagging."""

    def device(batch, *args, packed=None, **kwargs):
        with metrics.stage("phase_a"):
            metrics.count("sw_candidates", 3 * batch.num_reads)
        return int(batch.names[0][1:]), None

    def tail(meta, result):
        time.sleep(tail_delay)
        with metrics.stage("taxonomy"):
            pass

    def prepare(batch):
        screen_ops.label_low_complexity_reads(batch, 5, "cpu")
        return batch

    monkeypatch.setattr(trun, "process_chunk", device)
    monkeypatch.setattr(trun, "chunk_objects", lambda b, ov, batch: b)
    with trun.ChunkPipeline(PipelineConfig(), None, None, None,
                            depth=depth, tail=tail) as pipe:
        for batch, packed in pipe.read(stub_chunks(N_CHUNKS), prepare):
            pipe.feed(batch, {"batch": batch, "want_objects": True}, packed)
        pipe.drain()


@pytest.mark.parametrize("depth", [1, 3])
def test_no_profiler_keeps_no_span_and_opens_no_record_function(
        depth, monkeypatch):
    opened = []

    def record_function(name):
        opened.append(name)
        raise AssertionError(f"record_function({name!r}) opened")
    monkeypatch.setattr(metrics, "record_function", record_function)
    drive(depth, monkeypatch)
    with metrics.stage("outside"):
        metrics.count("outside")
    assert metrics.spans() == [] and opened == []
    stages = metrics.summary()
    assert stages["feed"]["calls"] == N_CHUNKS
    assert stages["phase_a"]["calls"] == N_CHUNKS
    assert metrics.counters()["sw_candidates"] == 3 * 2 * N_CHUNKS


class FakeClock:
    """perf_counter and thread_time that advance 1 s a read."""

    def __init__(self):
        self.t = 0.0

    def __getattr__(self, name):
        return getattr(time, name)

    def perf_counter(self):
        self.t += 1.0
        return self.t

    def thread_time(self):
        return 0.0


def test_tracing_leaves_the_aggregate_timers(monkeypatch):
    """The same nested stages, untraced and traced, on a clock that
    counts its reads: equal calls, seconds and items, and each span's
    interval is its stage's timed interval."""
    monkeypatch.setattr(metrics, "time", FakeClock())

    def work():
        with metrics.stage("outer", items=7):
            for _ in range(3):
                with metrics.stage("inner", items=2):
                    metrics.count("n", 5)
    work()
    off = metrics.summary()
    metrics.reset()
    with metrics.traced("calling", (0, None)):
        work()
    assert metrics.summary() == off
    assert off["outer"] == {"calls": 1, "seconds": 7.0, "items": 7,
                            "items_per_sec": 1.0}
    spans = metrics.spans()
    assert [s.name for s in spans] == ["inner"] * 3 + ["outer"]
    for name, entry in off.items():
        if name != "counters":
            assert sum(s.end - s.start for s in spans
                       if s.name == name) == entry["seconds"]


def by_id(spans):
    return {s.id: s for s in spans}


@pytest.mark.parametrize("depth", [3, 1])
def test_spans_carry_their_chunk_on_every_thread(depth, monkeypatch):
    with profiler() as prof:
        drive(depth, monkeypatch, tail_delay=0.01)
    spans = metrics.spans()
    ids = by_id(spans)
    assert len(ids) == len(spans)
    worker = {"calling"} if depth == 1 else {"reader", "tail"}
    reader = "calling" if depth == 1 else "reader"
    tailer = "calling" if depth == 1 else "tail"
    role_of = {"feed": "calling", "phase_a": "calling",
               "wait_reader": "calling", "wait_tail": "calling",
               "read": reader, "fastq_parse": reader,
               "low_complexity": reader, "pack_reads": reader,
               "tail": tailer, "taxonomy": tailer}
    for s in spans:
        assert s.role == role_of[s.name], s
        parent = ids.get(s.parent)
        if s.name == "wait_reader":
            # the wait for the read that chunk's feed handed on
            assert depth == 3 and parent.name == "feed"
            assert parent.chunk == s.chunk - 1 and parent.end <= s.start
        elif parent is not None and parent.role == s.role:
            # nested on its thread: the same chunk, inside its parent
            assert parent.chunk == s.chunk, (s, parent)
            assert parent.start <= s.start <= s.end <= parent.end
        elif s.name in ("read", "tail") and depth == 3:
            # a job's root: its parent is the feed that handed it on
            assert parent.name == "feed" and parent.role == "calling"
            assert parent.chunk == s.chunk - (s.name == "read")
            assert parent.start <= s.start
        else:
            assert s.parent is None and s.name in ("feed", "read"), s
    # the profiler went live before chunk 0's feed, after its read
    first_read = 1 if depth == 3 else 0
    for k in range(N_CHUNKS):
        names = {s.name for s in spans if s.chunk == k}
        want = {"feed", "phase_a", "tail", "taxonomy"}
        if k >= first_read:
            want |= {"read", "fastq_parse", "low_complexity"}
        if depth == 3 and k >= first_read:
            want |= {"pack_reads", "wait_reader"}
        assert want <= names, (k, names)
    assert {s.role for s in spans} - {"calling"} == (
        set() if depth == 1 else worker)
    if depth == 3:
        assert any(s.name == "wait_tail" for s in spans)
    feeds = [s for s in spans if s.name == "feed"]
    assert [f.chunk for f in feeds] == list(range(N_CHUNKS))
    assert all(f.counts == {"reads": 2} for f in feeds)
    assert sum(s.counts.get("sw_candidates", 0) for s in spans
               if s.name == "phase_a") == 6 * N_CHUNKS
    assert all(s.end >= s.start and s.cpu_end >= s.cpu_start
               for s in spans)
    # the calling thread's stages reach the profiler as kslam.* events
    names = {e.name for e in prof.events()}
    assert {"kslam.feed", "kslam.phase_a"} <= names


def test_all_threads_profile_shows_every_threads_stages(monkeypatch):
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=config) as prof:
        drive(3, monkeypatch)
    names = {e.name for e in prof.events()}
    assert {"kslam.feed", "kslam.read", "kslam.fastq_parse",
            "kslam.low_complexity", "kslam.tail", "kslam.taxonomy"} <= names


def test_counts_go_to_the_innermost_span():
    with metrics.traced("calling", (4, None)):
        with metrics.stage("outer"):
            metrics.count("a", 2)
            with metrics.stage("inner"):
                metrics.count("a", 3)
                metrics.count("b")
            metrics.count("c", 4)
    inner, outer = metrics.spans()
    assert inner.counts == {"a": 3, "b": 1} and inner.parent == outer.id
    assert outer.counts == {"a": 2, "c": 4} and outer.parent is None
    assert inner.chunk == outer.chunk == 4
    assert metrics.counters() == {"a": 5, "b": 1, "c": 4}


def test_ring_is_bounded():
    extra = 5
    with metrics.traced("calling", (0, None)):
        for _ in range(metrics.RING_SPANS + extra):
            with metrics.stage("s"):
                pass
    spans = metrics.spans()
    assert len(spans) == metrics.RING_SPANS
    assert metrics.summary()["s"]["calls"] == metrics.RING_SPANS + extra
    first = spans[0].id
    assert [s.id for s in spans] == list(range(first, first +
                                               metrics.RING_SPANS))


def test_threads_lose_no_update():
    """8 threads x 10,000 stage() and count() calls, half of them traced,
    under a short switch interval: exact totals."""
    n_threads, n_calls = 8, 10_000
    start = threading.Barrier(n_threads)

    def work(k):
        start.wait()
        origin = (k, None) if k % 2 else None
        with metrics.traced("calling", origin):
            for _ in range(n_calls):
                with metrics.stage("hot", items=3):
                    metrics.count("hits")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    hot = metrics.summary()["hot"]
    assert hot["calls"] == n_threads * n_calls
    assert hot["items"] == 3 * n_threads * n_calls
    assert metrics.counters() == {"hits": n_threads * n_calls}
    spans = metrics.spans()
    assert len(spans) == min(n_threads // 2 * n_calls, metrics.RING_SPANS)
    assert all(s.counts == {"hits": 1} and s.chunk % 2 for s in spans)


@pytest.fixture(scope="module")
def genbank(tmp_path_factory):
    root = tmp_path_factory.mktemp("metrics_spans_genbank")
    return root, fx.genbank_db(root)


@pytest.mark.parametrize("depth", [3, 1])
def test_traced_cli_keeps_the_counts_and_writes_the_same(depth, genbank):
    root, db = genbank
    flags = ["--num-reads-at-once", "5", "--device", "cpu",
             "--low-complexity-cutoff", "20"]
    if depth == 1:
        flags.append("--no-chunk-overlap")
    plain = fx.run_files(tcli.main, root, db, "plain", flags, single=False,
                         sam=False)
    assert metrics.spans() == []
    metrics.reset()
    with profiler():
        traced = fx.run_files(tcli.main, root, db, "traced", flags,
                              single=False, sam=False)
    assert traced == plain
    spans = metrics.spans()
    total = metrics.counters()
    feeds = [s for s in spans if s.name == "feed"]
    assert len(feeds) == 5                       # 24 pairs, 5 a chunk
    assert sum(f.counts["reads"] for f in feeds) == total["reads"] == 48

    def counted(name, stage):
        got = sum(s.counts.get(name, 0) for s in spans if s.name == stage)
        assert got == total[name] > 0, (name, stage)
    counted("sw_candidates", "phase_a_seed")
    counted("pairs_emitted", "insert_model")
    counted("insert_sizes", "insert_model")
    counted("pairs_kept", "result_fetch")
    counted("rows", "phase_b_rescore")
    counted("chains", "phase_b_rescore")
    assert {"read", "low_complexity", "phase_a_sw", "phase_a_pair",
            "phase_b", "taxonomy"} <= {s.name for s in spans}
    assert any(s.name == "wait_reader" for s in spans) == (depth == 3)
    for s in spans:
        if s.name == "phase_b_rescore":
            assert by_id(spans)[s.parent].name == "phase_b"
