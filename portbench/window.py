"""The system under test: kslam_tpu_torch loaded as its CLI loads it, and
driven in steady state through its chunk pipeline.

pipeline_config() makes the port's PipelineConfig of a configuration:
its "pipeline" group applied over the CLI's defaults, the one object
that the load, the chunk pipeline and the reference's parameters read.
load() makes the calls run.metagenomic_analysis makes under db_load:
TaxonomyDB.read_index, GenbankIndex.load, KmerIndex.load, then
align.DeviceDB.from_index, or on a mesh_shape dist.build_mesh and
dist.place_sharded_db, and run.device_tables.  Window.run() feeds
chunks of the cell's FASTQ pair (io.fastq.stream_read_batches, cycled
when the file ends) through run.ChunkPipeline at the CLI's depth (3, or
1 without chunk_overlap), with the CLI's prepare (low-complexity
flagging) and the tail its handle_chunk runs: with SAM (report_cigar),
io.sam_columns.write_sam of run.chunk_objects' reads, then the object
path's taxonomy; without, classify.chunk_taxa_from_arrays of the
fetched columns.  final_write() writes _PerRead, the XML and
_abbreviated once, as the CLI does at its end.

Every call into the program sits in a torch.profiler.record_function
span of the harness ("portbench.<layer>", a chunk's number after '#').
"""

from __future__ import annotations

import dataclasses
import gc
import os
import threading
import time

import torch
from torch.profiler import record_function

from kslam_tpu_torch.config import PipelineConfig, SWParams
from kslam_tpu_torch.db.genbank import GenbankIndex
from kslam_tpu_torch.db.kmer_index import KmerIndex
from kslam_tpu_torch.db.taxonomy import TaxonomyDB
from kslam_tpu_torch.io import sam as sam_io, sam_columns, xml_results
from kslam_tpu_torch.io.fastq import stream_read_batches
from kslam_tpu_torch.ops import screen as screen_ops
from kslam_tpu_torch.parallel import dist
from kslam_tpu_torch.pipeline import align, classify, run
from kslam_tpu_torch.utils import metrics

# settings whose runs the harness cannot drive or judge yet: a host
# screen needs a host table made from the traffic's host genome and the
# screen in the reference; the others change what a run writes
UNDRIVEN = {"host_screen_dir": "", "just_align": False, "resume": False,
            "sam_xa": False, "paired_data": True,
            "device_pipeline": "auto"}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def pipeline_config(cfg: dict) -> PipelineConfig:
    """The port's configuration of a run of `cfg` (configs/<name>.json):
    its "pipeline" group over PipelineConfig's defaults, which are the
    CLI's ("sw" as SWParams' fields)."""
    over = dict(cfg["pipeline"])
    if "sw" in over:
        over["sw"] = SWParams(**over["sw"])
    config = dataclasses.replace(PipelineConfig(), **over)
    for key, default in UNDRIVEN.items():
        if getattr(config, key) != default:
            raise ValueError(f"pipeline.{key} = {getattr(config, key)!r}: "
                             "the harness does not drive this setting")
    run.check_params(config.sw)
    config.command_line = "SLAM portbench"
    return config


def load(db_dir: str, device, config: PipelineConfig) -> tuple:
    """(state, seconds of each load call, synced)."""
    secs = {}
    state = {"db": None, "mesh": None, "sharded_db": None}

    def timed(name, fn):
        t = time.perf_counter()
        with record_function(f"portbench.load.{name}"):
            out = fn()
            sync(device)
        secs[name] = time.perf_counter() - t
        return out

    state["taxdb"] = timed("taxonomy", lambda: TaxonomyDB.read_index(
        os.path.join(db_dir, "taxDB")))
    gindex = state["gindex"] = timed("genomes",
                                     lambda: GenbankIndex.load(db_dir))
    kidx = timed("kmers", lambda: KmerIndex.load(db_dir))
    tables_on = device
    if config.mesh_shape:
        data, index = (int(x) for x in config.mesh_shape.split("x"))

        def place():
            mesh = dist.build_mesh(dist.local_devices(device), data=data,
                                   index=index)
            return mesh, dist.place_sharded_db(
                mesh, kidx, gindex.bases_concat, gindex.entry_offsets,
                genome_sharded=config.genome_sharded)
        state["mesh"], state["sharded_db"] = timed("shard_placement", place)
        tables_on = state["mesh"].devices[0][0]
    else:
        state["db"] = timed("device_db", lambda: align.DeviceDB.from_index(
            gindex, kidx, device, flat_scodes=False,
            prefix_rows=config.prefix_rows))
    del kidx
    state["entry_taxids"], state["lca_tables"] = timed(
        "device_tables", lambda: run.device_tables(
            gindex, state["taxdb"], tables_on))
    return state, secs


class Sink:
    """The SAM output: counts what is written and keeps the text that
    chunks marked for capture write (a run writes no SAM file: the text
    is made, then dropped)."""

    def __init__(self):
        self.bytes = 0
        self.capture = None

    def write(self, text: str) -> None:
        self.bytes += len(text)
        if self.capture is not None:
            self.capture.append(text)


def stage_seconds() -> dict:
    """The program's stage timers (utils.metrics): seconds by stage."""
    while True:
        try:
            return {k: s.seconds for k, s in list(metrics._STAGES.items())}
        except RuntimeError:      # a thread added a stage meanwhile
            continue


class Window:
    """One steady-state window over the chunks of (r1, r2)."""

    def __init__(self, state: dict, cfg: dict, config: PipelineConfig,
                 r1: str, r2: str, device, seconds: float, file_chunks: int,
                 capture_chunk: int):
        self.state, self.cfg, self.config = state, cfg, config
        self.r1, self.r2 = r1, r2
        self.device = device
        self.seconds = seconds
        self.file_chunks = file_chunks
        self.sam = config.report_cigar
        self.capture_chunk = capture_chunk
        self.warm = int(cfg["warm_chunks"])
        self.identified = []
        self.done = []               # (chunk, completion time, reads)
        self.fed = []                # (chunk, reads)
        self.t0 = self.t_end = self.t_end_chunk = None
        self.stages0 = self.stages1 = None
        self.sink = Sink() if self.sam else None
        self.sam_text = {}           # instance -> captured SAM text
        self.warm_log = []           # (chunk, completion, stage seconds)
        self.spans = []              # (kind, chunk, start, end), host
        self.anchor_t = None         # host time of the profiler's anchor
        self.gc_pauses = []          # (start, seconds) of full collections
        self._lock = threading.Lock()

    def _chunks(self):
        while True:
            n = 0
            for batch in stream_read_batches(
                    self.r1, self.r2, self.config.num_reads_at_once,
                    pad_len=self.config.max_read_len):
                n += 1
                yield batch
            if not n:
                return

    def _tail(self, meta, result):
        no, batch = meta["no"], meta["batch"]
        st = self.state
        t_in = time.perf_counter()
        with record_function(f"portbench.tail#{no}"):
            if self.sam:
                capture = no % self.file_chunks == self.capture_chunk
                if capture:
                    self.sink.capture = []
                with metrics.stage("sam_output"):
                    sam_columns.write_sam(self.sink, result, batch,
                                          st["gindex"], self.config,
                                          self.device)
                if capture:
                    self.sam_text[no] = "".join(self.sink.capture)
                    self.sink.capture = None
                with metrics.stage("taxonomy"):
                    self.identified.extend(
                        classify.convert_alignments_to_taxonomies(
                            result, st["gindex"], batch.names,
                            st["taxdb"]))
            else:
                with metrics.stage("taxonomy"):
                    self.identified.append(classify.chunk_taxa_from_arrays(
                        result, batch.names, st["gindex"]))
        t = time.perf_counter()
        self.spans.append(("tail", no, t_in, t))
        if no < self.warm:
            self.warm_log.append((no, t, dict(stage_seconds())))
        with self._lock:
            self.done.append((no, t, batch.num_reads))
            if no == self.warm - 1:
                self.t0 = t
                self.stages0 = stage_seconds()
            elif self.t0 is not None and self.t_end is None and \
                    t >= self.t0 + self.seconds:
                self.t_end, self.t_end_chunk = t, no
                self.stages1 = stage_seconds()

    def run(self, profiler=None) -> None:
        """Feed chunks until a tail completes `seconds` after the window's
        start; drain.  profiler: a torch.profiler.profile, entered before
        the last warm-up chunk is fed and left after the drain.  Full
        garbage collections are timed meanwhile (gc.callbacks)."""
        started = {}

        def on_gc(phase, info):
            if info.get("generation") != 2:
                return
            if phase == "start":
                started["t"] = time.perf_counter()
            elif "t" in started:
                t = started.pop("t")
                self.gc_pauses.append((t, time.perf_counter() - t))
        gc.callbacks.append(on_gc)
        try:
            self._run(profiler)
        finally:
            gc.callbacks.remove(on_gc)

    def _run(self, profiler) -> None:
        st = self.state
        counter = iter(range(1 << 62))

        def prepare(batch):
            no, t = next(counter), time.perf_counter()
            with record_function(f"portbench.prepare#{no}"):
                if self.config.low_complexity_cutoff:
                    screen_ops.label_low_complexity_reads(
                        batch, self.config.low_complexity_cutoff,
                        self.device)
                self.spans.append(("prepare", no, t, time.perf_counter()))
                return batch

        if self.sam:
            self.sink.write(sam_io.sam_header(st["gindex"],
                                              self.config.command_line))
        prof = None
        depth = 3 if self.config.chunk_overlap else 1
        with run.ChunkPipeline(self.config, st["db"], st["entry_taxids"],
                               st["lca_tables"], mesh=st["mesh"],
                               sharded_db=st["sharded_db"], depth=depth,
                               tail=self._tail) as pipe:
            for no, (batch, packed) in enumerate(pipe.read(self._chunks(),
                                                           prepare)):
                if profiler is not None and no == self.warm - 1:
                    prof = profiler.__enter__()
                    with record_function("portbench.anchor"):
                        self.anchor_t = time.perf_counter()
                self.fed.append((no, batch.num_reads))
                t = time.perf_counter()
                with record_function(f"portbench.feed#{no}"):
                    pipe.feed(batch, dict(batch=batch, no=no,
                                          want_objects=self.sam), packed)
                self.spans.append(("feed", no, t, time.perf_counter()))
                if self.t_end is not None:
                    break
            pipe.drain()
        sync(self.device)
        if prof is not None:
            profiler.__exit__(None, None, None)

    def window_gc_s(self) -> float:
        """Seconds of full (generation 2) collections in the window."""
        return sum(d for t, d in self.gc_pauses if self.t0 <= t < self.t_end)

    def window_chunk_s(self):
        """The gaps between the window's successive tail completions."""
        ts = sorted(t for _, t, _ in self.done if self.t0 <= t <= self.t_end)
        return [b - a for a, b in zip(ts, ts[1:])]

    def window_reads(self) -> int:
        """Reads (both mates) of the chunks whose tails completed in
        (t0, t_end]."""
        return sum(r for _, t, r in self.done if self.t0 < t <= self.t_end)

    def window_stages(self) -> dict:
        """Seconds each program stage added within the window."""
        return {k: v - self.stages0.get(k, 0.0)
                for k, v in self.stages1.items()}

    def final_write(self, out: str) -> None:
        st = self.state
        pairs = sum(r for _, _, r in self.done) // 2
        with record_function("portbench.final_write"):
            with metrics.stage("write_results"):
                with open(out + "_PerRead", "w") as fh:
                    xml_results.write_per_read_results(self.identified, fh)
                combined = classify.combine_taxonomies(self.identified)
                with open(out, "w") as fh:
                    xml_results.write_results(combined, fh, st["taxdb"],
                                              pairs)
                xml_results.write_abbreviated_results(
                    combined, out + "_abbreviated", st["taxdb"], pairs)
