"""The chunk software pipeline of kslam_tpu_torch (run.ChunkPipeline).

Through the port's CLI on the CPU, over 4 or more chunks: the default
(depth 3) writes byte for byte what --no-chunk-overlap (depth 1) writes,
for paired and single-end classification, a gene-less FASTA database,
--sam-file, --just-align and --mesh 2x2; one case also equals
kslam_tpu.cli.  On the pipeline itself, with stub stages: tails in
input order, on the threads they belong to; no more than `depth` chunks
in flight or alive; an error in the reader, in a chunk's device
work or in a tail reaches the caller after the earlier tails completed,
and no worker thread stays alive."""

import gc
import os
import random
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from kslam_tpu import cli as jcli
from kslam_tpu_torch import cli as tcli
from kslam_tpu_torch.config import PipelineConfig
from kslam_tpu_torch.io.fastq import ReadBatch
from kslam_tpu_torch.pipeline import run as trun
from kslam_tpu_torch.pipeline.checkpoint import RunCheckpoint
from tests import torch_cli_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genbank(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunk_pipeline_genbank")
    return root, fx.genbank_db(root)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    root = tmp_path_factory.mktemp("chunk_pipeline_fasta")
    return root, fx.fasta_db(root)


def worker_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("kslam-chunk")]


# name: (database, flags, single-end, SAM output); --num-reads-at-once 5
# makes 5 chunks of the 24 pairs (genbank) and 4 of the 18 (fasta)
CASES = {
    "paired": ("genbank", [], False, False),
    "single_end": ("genbank", [], True, False),
    "fasta_no_genes": ("fasta", [], False, False),
    "sam": ("genbank", [], False, True),
    "just_align": ("genbank", ["--just-align"], True, True),
    "mesh_2x2": ("genbank", ["--mesh", "2x2"], False, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_depth3_equals_depth1(case, genbank, fasta, monkeypatch):
    which, flags, single, sam = CASES[case]
    root, db = genbank if which == "genbank" else fasta
    depths = []
    real = trun.ChunkPipeline

    def recording(*args, **kwargs):
        pipe = real(*args, **kwargs)
        depths.append(pipe.depth)
        return pipe
    monkeypatch.setattr(trun, "ChunkPipeline", recording)
    flags = flags + ["--num-reads-at-once", "5", "--device", "cpu"]
    piped = fx.run_files(tcli.main, root, db, f"{case}_d3", flags, single,
                         sam)
    seq = fx.run_files(tcli.main, root, db, f"{case}_d1",
                       flags + ["--no-chunk-overlap"], single, sam)
    assert depths == [3, 1]
    assert piped == seq
    assert piped["sam"] if sam else piped["_PerRead"]
    assert worker_threads() == []


def test_depth3_equals_reference_cli(genbank):
    """The pipelined port writes what kslam_tpu.cli writes (SAM without
    @PG, XML, _PerRead, _abbreviated) over 5 chunks."""
    root, db = genbank
    flags = ["--num-reads-at-once", "5", "--device-pipeline", "on"]
    got = fx.run_files(tcli.main, root, db, "ref_d3",
                       flags + ["--device", "cpu"], single=False)
    ref = fx.run_files(jcli.main, root, db, "ref_jax", flags, single=False)
    assert got == ref
    assert len(got["sam"]) > 24


@pytest.mark.parametrize("flags,depth", [
    ([], 3), (["--no-chunk-overlap"], 1), (["--mesh", "2x2"], 3),
    (["--mesh", "2x2", "--no-chunk-overlap"], 1),
    (["--device-pipeline", "off"], 1)],
    ids=["default", "no_overlap", "mesh", "mesh_no_overlap", "host_path"])
def test_cli_depth(flags, depth, genbank, monkeypatch):
    """--no-chunk-overlap gives depth 1, the default depth 3, on one
    device and on a mesh; the host-object path runs at depth 1."""
    root, db = genbank
    depths = []
    real = trun.ChunkPipeline

    def recording(*args, **kwargs):
        depths.append(kwargs["depth"])
        return real(*args, **kwargs)
    monkeypatch.setattr(trun, "ChunkPipeline", recording)
    fx.run_files(tcli.main, root, db, "depth", flags + [
        "--num-reads", "6", "--device", "cpu"], single=False, sam=False)
    assert depths == [depth]


def test_crash_in_device_work_keeps_earlier_chunks(genbank, monkeypatch):
    """process_chunk raising in chunk 3 of 5 at depth 3: the checkpoint
    holds chunks 1 and 2, and --resume then writes what an uninterrupted
    depth-1 run writes."""
    root, db = genbank
    flags = ["--num-reads-at-once", "5", "--device", "cpu", "--resume"]
    full = fx.run_files(tcli.main, root, db, "crash_full",
                        flags + ["--no-chunk-overlap"], single=False)
    real = trun.process_chunk
    calls = {"n": 0}

    def crashing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt("simulated crash")
        return real(*args, **kwargs)
    monkeypatch.setattr(trun, "process_chunk", crashing)
    with pytest.raises(KeyboardInterrupt):
        fx.run_files(tcli.main, root, db, "crash_part", flags, single=False)
    assert worker_threads() == []
    ck = RunCheckpoint(str(root / "out_crash_part"))
    assert ck.load()[0] == 2
    monkeypatch.setattr(trun, "process_chunk", real)
    assert fx.run_files(tcli.main, root, db, "crash_part", flags,
                        single=False) == full
    assert not os.path.exists(ck.cursor_path)


# the pipeline with stub stages: chunk k is a one-read batch named q<k>

class Boom(Exception):
    pass


def stub_batches(n, trace, alive, fail_at=None, delay=0.0):
    """n one-read chunks; `alive` gets, as each chunk is made, how many
    chunks are alive (not yet freed) with it."""
    rng = random.Random(n)
    made = []
    for k in range(n):
        if k == fail_at:
            raise Boom(f"reader, chunk {k}")
        time.sleep(rng.random() * delay)
        trace.append(("parse", k, threading.current_thread().name))
        batch = ReadBatch([f"q{k}"], np.full((1, 40), 65, np.uint8),
                          np.array([40], np.int32),
                          np.zeros((1, 40), np.uint8), paired=False)
        made.append(weakref.ref(batch))
        alive.append(sum(r() is not None for r in made))
        yield batch
        del batch


def drive(depth, n, monkeypatch, fail_reader=None, fail_device=None,
          fail_tail=None, tail_delay=0.0, delay=0.0):
    """Runs n stub chunks through ChunkPipeline as metagenomic_analysis
    does, with the cyclic garbage collector off; returns (trace of
    (event, chunk, thread), the chunks alive as each was made, error
    raised or None).  After a run without error the pipeline, and with
    it the device DB it holds, is freed as soon as it goes out of use."""
    trace, alive = [], []
    rng = random.Random(depth)

    def device(batch, *args, packed=None, **kwargs):
        k = int(batch.names[0][1:])
        if k == fail_device:
            raise Boom(f"device, chunk {k}")
        time.sleep(rng.random() * delay)
        trace.append(("device", k, threading.current_thread().name))
        assert (packed is None) == (depth == 1)
        return k, None

    def tail(meta, result):
        time.sleep(tail_delay)
        if result == fail_tail:
            raise Boom(f"tail, chunk {result}")
        trace.append(("tail", result, threading.current_thread().name))

    monkeypatch.setattr(trun, "process_chunk", device)
    monkeypatch.setattr(trun, "chunk_objects", lambda b, ov, batch: b)
    error = None
    gc.disable()
    try:
        with trun.ChunkPipeline(PipelineConfig(), None, None, None,
                                depth=depth, tail=tail) as pipe:
            for batch, packed in pipe.read(
                    stub_batches(n, trace, alive, fail_reader, delay),
                    lambda b: b):
                pipe.feed(batch, {"batch": batch, "want_objects": True},
                          packed)
            pipe.drain()
        freed = weakref.ref(pipe)
        del pipe
        assert freed() is None
    except Boom as err:
        error = err
    finally:
        gc.enable()
    assert worker_threads() == []
    return trace, alive, error


def events(trace, kind):
    return [k for e, k, _ in trace if e == kind]


@pytest.mark.parametrize("depth", [1, 2, 3, 4])
def test_results_in_input_order(depth, monkeypatch):
    trace, _, error = drive(depth, 12, monkeypatch, delay=0.01,
                            tail_delay=0.005)
    assert error is None
    assert events(trace, "device") == list(range(12))
    assert events(trace, "tail") == list(range(12))
    threads = {e: {t for e2, _, t in trace if e2 == e}
               for e in ("parse", "device", "tail")}
    main = threading.current_thread().name
    if depth == 1:
        assert threads == {e: {main} for e in threads}
    else:
        assert threads == {"parse": {"kslam-chunk-reader_0"},
                           "device": {main},
                           "tail": {"kslam-chunk-tail_0"}}


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_in_flight_bounded_by_depth(depth, monkeypatch):
    """With a slow tail the reader runs ahead as far as the bound allows:
    chunks parsed minus tails completed reaches depth, never more, and
    no more than depth chunks are alive (a chunk is freed when its tail
    returns, not when the caller next looks)."""
    trace, alive, error = drive(depth, 10, monkeypatch, tail_delay=0.03)
    assert error is None
    assert events(trace, "tail") == list(range(10))
    in_flight = peak = 0
    for event, _, _ in trace:
        in_flight += {"parse": 1, "tail": -1}.get(event, 0)
        peak = max(peak, in_flight)
    assert peak == depth
    assert max(alive) == depth


@pytest.mark.parametrize("depth", [1, 3])
def test_reader_error_reaches_caller(depth, monkeypatch):
    trace, _, error = drive(depth, 8, monkeypatch, fail_reader=5)
    assert str(error) == "reader, chunk 5"
    assert events(trace, "tail") == [0, 1, 2, 3, 4]
    assert events(trace, "device") == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("depth", [1, 3])
def test_device_error_completes_earlier_tails(depth, monkeypatch):
    trace, _, error = drive(depth, 8, monkeypatch, fail_device=4,
                                  tail_delay=0.02)
    assert str(error) == "device, chunk 4"
    assert events(trace, "tail") == [0, 1, 2, 3]


@pytest.mark.parametrize("depth", [1, 3])
def test_tail_error_reaches_caller_and_stops_later_tails(depth,
                                                         monkeypatch):
    trace, _, error = drive(depth, 8, monkeypatch, fail_tail=3,
                            tail_delay=0.01)
    assert str(error) == "tail, chunk 3"
    assert events(trace, "tail") == [0, 1, 2]
