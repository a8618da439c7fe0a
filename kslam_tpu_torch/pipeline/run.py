"""End-to-end run: metagenomicAnalysis_Low_Mem rebuilt on torch
(SLAM.h:159-268).

Counterpart of kslam_tpu/pipeline/run.py.  Each chunk may first lose its
host reads (--host-screen) and have its low-complexity reads counted
(--low-complexity-cutoff), then runs one of two paths on the run's
device:

  * the device pipeline (--device-pipeline on, and auto): device batches
    of config.read_batch reads through phase A (or, with --mesh DxS, one
    sub-batch per data row through the sharded phase A of
    parallel/dist.py), one chunk-wide insert model on the host, the
    chunk-wide phase B; the per-read taxonomy
    comes straight off the device columns, or, with SAM output or
    --just-align, through the host object model
    (device_path.chunk_to_host_pairs);
  * the host-object path (--device-pipeline off): align_batch_to_database
    (exact join, flat-window SW on the device), then host pairing,
    screens and pseudo-assembly over Python objects (pipeline/pairing.py).

On the device pipeline, ChunkPipeline overlaps the next chunk's parse
and packing and the last chunk's host tail with a chunk's device work
(depth 3; --no-chunk-overlap runs one chunk at a time, depth 1).  SAM
lines are written per chunk, in chunk order, on either path from
columns (io/sam_columns.py: the cigars and diffs by ops/sam_cuda.py's
kernels on the run's device); the per-read TSV, the
combined XML and the abbreviated TSV at the end (not with
--just-align).  --resume continues an interrupted run from its chunk
checkpoint (pipeline/checkpoint.py).
"""

from __future__ import annotations

import collections
import concurrent.futures
import os
import sys
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..db.genbank import GenbankIndex
from ..db.kmer_index import KmerIndex
from ..db.taxonomy import TaxonomyDB
from ..io import sam as sam_io, sam_columns
from ..io import xml_results
from ..io.fastq import ReadBatch, stream_read_batches
from ..ops import encode, lca as lca_ops, screen as screen_ops
from ..ops.sw import check_params
from ..parallel import dist
from ..utils import metrics
from ..utils.logging import log
from . import align, classify, device_path, pairing
from .checkpoint import RunCheckpoint


def apply_host_screen(batch: ReadBatch, table, kind: str) -> ReadBatch:
    """Remove host-organism reads (labelHostReads semantics,
    KMerLookupTable.h:257-270).  table: the host table's tensor
    (ops/screen.table_tensor) on the run's device.  For paired data the
    whole pair is dropped when either mate is host, as in the reference
    package."""
    is_host = screen_ops.label_host_reads(batch, table, lookup_kind=kind)
    if batch.paired:
        mid = batch.midpoint
        pair_host = is_host[:mid] | is_host[mid:]
        keep = np.concatenate([~pair_host, ~pair_host])
    else:
        keep = ~is_host
    n_drop = int((~keep).sum())
    if n_drop:
        log(f"Screened {n_drop} host reads, now got {int(keep.sum())}")
    idx = np.flatnonzero(keep)
    return ReadBatch(
        names=[batch.names[i] for i in idx], bases=batch.bases[idx],
        lengths=batch.lengths[idx], quality=batch.quality[idx],
        paired=batch.paired)


class ChunkLayout(NamedTuple):
    """How a chunk splits into device batches: reads padded to l bases,
    `unit` pairs (paired) or reads per batch, R2 rows from mid_local."""
    l: int
    unit: int
    num_batches: int
    mid_local: int
    rows: int


def chunk_layout(batch: ReadBatch, config: PipelineConfig,
                 mesh=None) -> ChunkLayout:
    """The device batches of a chunk: config.read_batch reads each, or
    one sub-batch per data row of a mesh."""
    paired = batch.paired
    # pad reads to the chunk's real maximum (rounded to 8), as the
    # reference package does
    l_data = int(batch.lengths.max()) if batch.num_reads else 0
    l = min(config.max_read_len, max(-(-l_data // 8) * 8, 40))
    n_units = batch.midpoint if paired else batch.num_reads  # pairs/reads
    if mesh is not None:
        num_batches = mesh.shape["data"]
        unit = max(-(-n_units // num_batches), 1)
    else:
        unit = max(config.read_batch // (2 if paired else 1), 1)
        if n_units <= unit:
            unit = max(n_units, 1)
        num_batches = -(-n_units // unit) if n_units else 1
    return ChunkLayout(l, unit, num_batches, unit if paired else 0,
                       unit * (2 if paired else 1))


def _batch_arrays(batch: ReadBatch, lay: ChunkLayout, i: int):
    """Device batch i of a chunk, padded: (ASCII bases u8 [rows, l],
    lengths int32 [rows]), R1 rows first, R2 rows from lay.mid_local."""
    chunk_mid = batch.midpoint if batch.paired else 0
    n_units = chunk_mid if batch.paired else batch.num_reads
    lo = i * lay.unit
    k = max(min(lay.unit, n_units - lo), 0)
    bases = np.zeros((lay.rows, lay.l), dtype=np.uint8)
    lengths = np.zeros(lay.rows, dtype=np.int32)
    bl = min(batch.bases.shape[1], lay.l)
    bases[:k, :bl] = batch.bases[lo:lo + k, :bl]
    lengths[:k] = batch.lengths[lo:lo + k]
    if batch.paired:
        m = lay.mid_local
        bases[m:m + k, :bl] = batch.bases[chunk_mid + lo:chunk_mid + lo + k,
                                          :bl]
        lengths[m:m + k] = batch.lengths[chunk_mid + lo:chunk_mid + lo + k]
    return bases, lengths


def pack_device_batch(batch: ReadBatch, lay: ChunkLayout, i: int):
    """Device batch i padded and 2-bit packed: (packed, nbits, kbits,
    lengths) of encode.pack_reads_np."""
    bases, lengths = _batch_arrays(batch, lay, i)
    return (*encode.pack_reads_np(bases), lengths)


def pack_chunk(batch: ReadBatch, config: PipelineConfig, mesh=None):
    """Every device batch of a chunk, packed as process_chunk packs them:
    one (packed, nbits, kbits, lengths) per device batch, or one for all
    the data rows of a mesh."""
    lay = chunk_layout(batch, config, mesh)
    if mesh is None:
        return [pack_device_batch(batch, lay, i)
                for i in range(lay.num_batches)]
    parts = [_batch_arrays(batch, lay, i) for i in range(lay.num_batches)]
    return [(*encode.pack_reads_np(np.concatenate([b for b, _ in parts])),
             np.concatenate([le for _, le in parts]))]


def process_chunk(batch: ReadBatch, db: align.DeviceDB,
                  config: PipelineConfig, entry_taxids,
                  lca_tables, mesh=None, sharded_db=None, packed=None):
    """One chunk through phase A (per device batch), the chunk-wide
    insert model and phase B; returns the chunk's (PhaseBOut, overlap
    columns) of device_path.run_chunk_phase_b.

    mesh/sharded_db (parallel/dist.py): phase A runs as one sharded step
    over a (data, index) mesh instead: the chunk splits into one
    sub-batch per data row (db is not read), and each row's output is
    consumed by the same chunk-wide phase B as a device batch, so the
    results are those of one device.

    packed: the chunk's device batches from pack_chunk (the pipeline's
    reader packs them ahead); None packs each batch here, just before
    its phase A."""
    paired = batch.paired
    lay = chunk_layout(batch, config, mesh)
    chunk_mid = batch.midpoint if paired else 0
    p = config.sw
    if mesh is not None:
        step = dist.make_sharded_phase_a(
            mesh, paired=paired, match_s=p.match, mismatch=p.mismatch,
            gap_open=p.gap_open, gap_extend=p.gap_extend, window_len=lay.l,
            score_threshold=config.score_threshold,
            genome_sharded=config.genome_sharded)
        if packed is None:
            with metrics.stage("pack_reads"):
                packed = pack_chunk(batch, config, mesh)
        (codes, nbits, kbits, lengths), = packed
        with metrics.stage("phase_a", items=lay.rows * lay.num_batches):
            a_list = dist.split_phase_a(
                step(codes, lengths, lay.mid_local, sharded_db, nbits=nbits,
                     kbits=kbits), mesh)
    else:
        dev = db.kmers.device
        a_list = []
        for i in range(lay.num_batches):
            if packed is None:
                with metrics.stage("pack_reads"):
                    codes, nbits, kbits, lengths = pack_device_batch(
                        batch, lay, i)
            else:
                codes, nbits, kbits, lengths = packed[i]
            with metrics.stage("phase_a", items=lay.rows):
                a_list.append(device_path.phase_a(
                    torch.as_tensor(codes).to(dev),
                    torch.as_tensor(lengths).to(dev), lay.mid_local,
                    db.kmers, db.idx_pack, db.genome_chunks,
                    db.entry_offsets, match_s=p.match, mismatch=p.mismatch,
                    gap_open=p.gap_open, gap_extend=p.gap_extend,
                    window_len=lay.l, score_threshold=config.score_threshold,
                    paired=paired, nbits=torch.as_tensor(nbits).to(dev),
                    kbits=torch.as_tensor(kbits).to(dev),
                    **db.join_tables()))

    max_insert = 2**32 - 1
    if paired:
        with metrics.stage("insert_model"):
            parts = []
            for a in a_list:
                n = int(a.pairs.count)
                metrics.count("pairs_emitted", n)
                ins = a.pairs.insert_size[:n].cpu().numpy()
                ins = ins[ins != 0].astype(np.int64)
                parts.append(np.where(ins >= 2**31, ins - 2**32, ins))
            allins = np.concatenate(parts)
            metrics.count("insert_sizes", len(allins))
            max_insert = pairing.max_allowed_insert_size_from_sizes(allins)
        log(f"max allowed insert size {max_insert}")
    with metrics.stage("phase_b"):
        return device_path.run_chunk_phase_b(
            a_list, lay.mid_local, chunk_mid, lay.unit,
            min(max_insert, 2**32 - 1), entry_taxids, lca_tables,
            fraction=config.score_fraction_threshold,
            perform_pseudo_assembly=config.perform_pseudo_assembly,
            paired=paired)


def chunk_objects(b: device_path.PhaseBOut, ov_cols, batch: ReadBatch):
    """The host object model of a chunk's device result (SAM output,
    --just-align), each read carrying its device LCA."""
    with metrics.stage("to_host_pairs"):
        reads, lcas = device_path.chunk_to_host_pairs(
            b, ov_cols, batch.midpoint if batch.paired else 0)
        for read in reads:
            read.device_lca = lcas.get(read.r1_pos, 0)
    return reads


def device_tables(gindex: GenbankIndex, taxdb: TaxonomyDB, device):
    """(entry taxid column, LCA tables) on `device`: what phase B reads
    besides the chunk's own columns."""
    return (torch.as_tensor(gindex.taxonomy_ids.astype(np.int64)).to(device),
            lca_ops.build_device_tables(taxdb, device))


class ChunkPipeline:
    """Software pipeline over chunks: with depth >= 2, three chunks move
    at once, each stage on a thread of its own.

      reader (a worker thread; read()): the FASTQ parse, host screen and
          low-complexity flagging of chunk i+1, and its padding and 2-bit
          packing into device batches (pack_chunk);
      calling thread (feed()): process_chunk of chunk i (phase A per
          device batch or the mesh step, the insert model, phase B) and
          its device-to-host fetch (the classification columns, or the
          object model for SAM and --just-align);
      tail (a worker thread): `tail(meta, result)` of chunk i-1 (cigars
          and SAM text, taxonomy, the checkpoint), strictly in chunk
          order; after a tail fails, no later tail runs.

    At most `depth` chunks are alive, from the start of their parse to
    the end of their tail: feed() starts the next chunk's read only once
    at most depth - 2 tails are pending, and a chunk is dropped when its
    tail returns.  Results reach the caller through `tail` only.  Chunks
    meet only at the final combine, so the results are those of depth 1
    (--no-chunk-overlap), which runs the same stages one after another
    on the calling thread and starts no thread.  Stages that launch
    device work (the host screen, the flagging) share the card's stream
    with the calling thread; the tail's SAM kernels run on a stream of
    their own (io/sam_columns.py).  An error on any thread reaches the caller:
    on the way out the pipeline finishes the tails of the chunks already
    fed, joins both threads, and raises the first error in chunk order.

    Chunks are numbered in read order.  While a torch profiler is live
    on the thread that calls feed(), each chunk's work is traced
    (utils/metrics spans): its root spans `read` (reader thread),
    `feed` and `tail` (tail thread) hold the stages they run, and the
    calling thread's waits are the spans `wait_reader` (for the next
    chunk's read) and `wait_tail` (for a pending tail).  Depth 1 runs
    the same spans on the calling thread.

    Left out of kslam_tpu's ChunkPipeline: the adaptive transfer caps
    (observe_cap and its hints), the split phase B (enqueue, fetch,
    finish) and the compact classification transfers.  They size static
    TPU shapes and order transfers on the TPU's in-order queue; the
    port's shapes are exact and phase A syncs the host, so its overlap
    comes from moving the host-only stages off the thread that drives
    the card.
    """

    def __init__(self, config: PipelineConfig, db, entry_taxids,
                 lca_tables, mesh=None, sharded_db=None, depth: int = 3,
                 *, tail):
        self.config = config
        self.db = db
        self.entry_taxids = entry_taxids
        self.lca_tables = lca_tables
        self.mesh = mesh
        self.sharded_db = sharded_db
        self.depth = max(1, depth)
        self.tail = tail
        self._reader = self._tails = None
        self._source = None          # read()'s (chunks, prepare)
        self._ahead = None           # the next chunk's (read future, origin)
        self._reads = self._fed = 0  # chunks read, fed
        self._pending: collections.deque = collections.deque()  # tails
        self._tail_failed = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        for fut in self._pending:
            err = fut.exception()
            if err is not None and err is not exc:
                raise err
        return False

    def read(self, chunks, prepare):
        """(batch, packed) for each ReadBatch of `chunks`, after
        `prepare` (host screen, flagging); at depth >= 2 made one chunk
        ahead on the reader thread, with packed = pack_chunk(batch); at
        depth 1 made here, with packed None (process_chunk packs)."""
        if self.depth == 1:
            while True:
                origin = (self._reads, None) if metrics.profiler_live() \
                    else None
                self._reads += 1
                with metrics.traced("calling", origin), \
                        metrics.stage("read"):
                    with metrics.stage("fastq_parse"):
                        batch = next(chunks, None)
                    if batch is not None:
                        batch = prepare(batch)
                if batch is None:
                    return
                yield batch, None
        self._reader = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="kslam-chunk-reader")
        self._source = chunks, prepare
        while True:
            if self._ahead is None:      # no feed() since the last chunk
                self._read_ahead()
            future, origin = self._ahead
            with metrics.traced("calling", origin), \
                    metrics.stage("wait_reader"):
                item = future.result()
            self._ahead = None
            if item is None:
                return
            yield item

    def _read_ahead(self) -> None:
        origin = metrics.handoff(self._reads)
        self._reads += 1
        self._ahead = (self._reader.submit(self._read_one, *self._source,
                                           origin), origin)

    def _read_one(self, chunks, prepare, origin):
        with metrics.traced("reader", origin), metrics.stage("read"):
            with metrics.stage("fastq_parse"):
                batch = next(chunks, None)
            if batch is None:
                return None
            batch = prepare(batch)
            with metrics.stage("pack_reads"):
                return batch, pack_chunk(batch, self.config, self.mesh)

    def feed(self, batch: ReadBatch, meta: dict, packed=None) -> None:
        """Start the next chunk's read, run this chunk's device work and
        fetch here, and hand its tail on.  meta["want_objects"]: fetch
        the object model (chunk_objects) rather than the classification
        columns.  Traced (with its read and tail) while a torch profiler
        is live on this thread."""
        no = self._fed
        self._fed += 1
        origin = (no, None) if metrics.profiler_live() else None
        with metrics.traced("calling", origin), metrics.stage("feed"):
            metrics.count("reads", batch.num_reads)
            if self.depth > 1:
                self._wait(self.depth - 2)
                self._read_ahead()
            b, ov_cols = process_chunk(batch, self.db, self.config,
                                       self.entry_taxids, self.lca_tables,
                                       mesh=self.mesh,
                                       sharded_db=self.sharded_db,
                                       packed=packed)
            if meta.get("want_objects", True):
                result = chunk_objects(b, ov_cols, batch)
            else:
                with metrics.stage("result_fetch"):
                    result = classify.fetch_classify_arrays(b)
            del b, ov_cols          # the chunk's device buffers
            if self.depth == 1:
                with metrics.stage("tail"):
                    self.tail(meta, result)
                return
            if self._tails is None:
                self._tails = concurrent.futures.ThreadPoolExecutor(
                    1, thread_name_prefix="kslam-chunk-tail")
            self._pending.append(self._tails.submit(
                self._tail, [meta, result], metrics.handoff(no)))

    def _tail(self, job, origin):
        # emptied here, so that the chunk is freed when this returns,
        # before its future completes and feed() reads ahead again
        meta, result = job
        job.clear()
        try:
            if not self._tail_failed:
                with metrics.traced("tail", origin), metrics.stage("tail"):
                    self.tail(meta, result)
        except BaseException:
            self._tail_failed = True
            raise

    def _wait(self, n: int) -> None:
        """Wait until at most n tails are pending, raising the first
        tail's error."""
        while len(self._pending) > n:
            with metrics.stage("wait_tail"):
                self._pending[0].result()
            self._pending.popleft()

    def drain(self) -> None:
        """Wait for the tails of every chunk fed."""
        self._wait(0)

    def close(self) -> None:
        """Let the read and the tails already handed on finish, and join
        both threads."""
        for pool in (self._reader, self._tails):
            if pool is not None:
                pool.shutdown(wait=True)


def process_batch(batch: ReadBatch, db: align.DeviceDB,
                  config: PipelineConfig) -> List[pairing.ReadPairAlignments]:
    """One chunk through alignment, pairing and screens (SLAM.h:209-234)."""
    with metrics.stage("align", items=batch.num_reads):
        overlaps = align.align_batch_to_database(batch, db, config)
    log(f"{len(overlaps)} overlaps survive the score screen")
    metrics.count("overlaps_screened", len(overlaps))
    read_lengths = batch.lengths
    with metrics.stage("pairing"):
        if batch.paired:
            mid = batch.midpoint
            pairs = pairing.get_paired_overlaps(overlaps, read_lengths, mid)
            reads_and_pairs = pairing.group_pairs_per_read(pairs, mid)
            max_insert = pairing.max_allowed_insert_size(reads_and_pairs)
            log(f"max allowed insert size {max_insert}")
            pairing.screen_pairs_by_insert_size(reads_and_pairs, max_insert,
                                                replace=True)
            pairing.screen_pairs_by_score(reads_and_pairs,
                                          config.score_fraction_threshold)
        else:
            reads_and_pairs = pairing.dummy_pairs_from_single_end(overlaps)
            pairing.screen_pairs_by_score(reads_and_pairs,
                                          config.score_fraction_threshold)
    if config.perform_pseudo_assembly:
        with metrics.stage("pseudo_assembly"):
            pairing.pseudo_assembly(reads_and_pairs)
            pairing.screen_pairs_by_score(reads_and_pairs,
                                          config.score_fraction_threshold)
    return reads_and_pairs


def _fill_cigars(reads_and_pairs, batch: ReadBatch, gindex: GenbankIndex,
                 config: PipelineConfig) -> None:
    """Deferred cigar generation for SAM survivors only (top
    numSAMAlignments per read; identical output to the reference's
    compute-everything approach)."""
    todo = []
    for read in reads_and_pairs:
        read.pairs.sort(key=lambda p: -p.combined_score)
        for pair in read.pairs[:config.num_sam_alignments]:
            for o in (pair.r1, pair.r2):
                if o is not None and o.cigar is None:
                    todo.append(o)
    if not todo:
        return
    if align.compute_cigars_batch(todo, batch, gindex, config):
        return
    for o in todo:  # pure-Python fallback (native library unavailable)
        align.compute_overlap_cigar(
            o, batch.base_string(o.read_id),
            gindex.entries[o.entry_id].bases, config)


def metagenomic_analysis(r1_path: str, r2_path: Optional[str],
                         database_dir: str, out_path: str, sam_path: str,
                         config: PipelineConfig, device) -> None:
    """metagenomicAnalysis_Low_Mem (SLAM.h:159-268) on `device`."""
    check_params(config.sw)
    log("Performing metagenomic analysis")
    if sam_path:
        config.report_cigar = True
    config.paired_data = bool(r2_path)
    # "auto" runs the device pipeline: this port runs it on any device
    use_device = config.device_pipeline != "off"
    db = mesh = sharded_db = None
    with metrics.stage("db_load"):
        with metrics.stage("db_load_taxonomy"):
            taxdb = TaxonomyDB.read_index(f"{database_dir}/taxDB") \
                if not config.just_align else TaxonomyDB()
        with metrics.stage("db_load_genomes"):
            gindex = GenbankIndex.load(database_dir)
        with metrics.stage("db_load_kmers"):
            kidx = KmerIndex.load(database_dir)
        if config.mesh_shape:
            # the reference package's parse (a malformed shape raises the
            # same ValueError); a mesh forces the device pipeline
            d_axis, s_axis = (int(x) for x in config.mesh_shape.split("x"))
            use_device = True
        else:
            db = align.DeviceDB.from_index(gindex, kidx, device,
                                           flat_scodes=not use_device,
                                           prefix_rows=config.prefix_rows)
    if config.mesh_shape:
        with metrics.stage("shard_placement"):
            mesh = dist.build_mesh(dist.local_devices(device),
                                   data=d_axis, index=s_axis)
            sharded_db = dist.place_sharded_db(
                mesh, kidx, gindex.bases_concat, gindex.entry_offsets,
                genome_sharded=config.genome_sharded)
        log(f"Using (data={d_axis}, index={s_axis}) device mesh"
            + (" with entry-owner genome shards"
               if config.genome_sharded else ""))
    entry_taxids = lca_tables = None
    if use_device:
        with metrics.stage("db_load"):
            # phase B runs where split_phase_a puts a mesh's rows
            entry_taxids, lca_tables = device_tables(
                gindex, taxdb,
                device if mesh is None else mesh.devices[0][0])
    host_table = host_kind = None
    if config.host_screen_dir:
        from ..db.host_table import HostTable
        table = HostTable.load(config.host_screen_dir)
        host_kind = table.kind
        host_table = screen_ops.table_tensor(table, device)
        log("Host screening using k = 16")

    identified: List[classify.IdentifiedTaxonomy] = []
    num_reads = 0
    chunks_done = 0
    sam_bytes = 0
    ck = None
    if config.resume:
        ck = RunCheckpoint(out_path or sam_path)
        state = ck.load()
        if state is not None:
            chunks_done, num_reads, sam_bytes, identified = state
            log(f"Resuming after {chunks_done} chunks / {num_reads} reads")
    resumed = chunks_done > 0
    if resumed and sam_path and os.path.exists(sam_path):
        # drop partial lines written after the last completed chunk
        os.truncate(sam_path, sam_bytes)
    log(f"Using the {torch.device(device).type} "
        + ("device pipeline" if use_device else "host-object pipeline"))

    def handle_chunk(sam_file, batch, reads_and_pairs, arrays,
                     reads_so_far):
        """Host tail of one chunk: SAM text, taxonomy, checkpoint.
        arrays: the columnar classification arrays, or None for the
        object path (reads_and_pairs)."""
        nonlocal chunks_done
        if sam_file:
            log("Writing SAM output")
            with metrics.stage("sam_output"):
                sam_columns.write_sam(sam_file, reads_and_pairs, batch,
                                      gindex, config, device)
        chunks_done += 1
        new_identified = []
        if not config.just_align:
            with metrics.stage("taxonomy"):
                if arrays is not None:
                    new_identified = classify.chunk_taxa_from_arrays(
                        arrays, batch.names, gindex)
                    identified.append(new_identified)
                else:
                    new_identified = \
                        classify.convert_alignments_to_taxonomies(
                            reads_and_pairs, gindex, batch.names, taxdb)
                    identified.extend(new_identified)
        if ck is not None:
            if sam_file:
                sam_file.flush()
            ck.save_chunk(chunks_done, reads_so_far, new_identified,
                          sam_file.tell() if sam_file else 0)
        if not config.just_align:
            log(f"Processed\t{reads_so_far}\t reads")

    def prepare(batch):
        """A chunk's host screen and low-complexity flagging."""
        if host_table is not None:
            with metrics.stage("host_screen"):
                batch = apply_host_screen(batch, host_table, host_kind)
        if config.low_complexity_cutoff:
            lc = screen_ops.label_low_complexity_reads(
                batch, config.low_complexity_cutoff, device)
            log(f"Low complexity screening flagged {int(lc.sum())} reads")
        return batch

    def tail(meta, result):
        columnar = not meta["want_objects"]
        handle_chunk(sam_file, meta["batch"], None if columnar else result,
                     result if columnar else None, meta["reads"])

    # chunk software pipeline (ChunkPipeline): the next chunk's parse and
    # packing and the last chunk's host tail run beside this chunk's
    # device work (results unchanged: chunks only meet at the final
    # combine); the host-object path runs its chunks one after another
    depth = 3 if use_device and config.chunk_overlap else 1
    sam_file = open(sam_path, "a" if resumed else "w") if sam_path else None
    try:
        if sam_file and not resumed:
            sam_file.write(sam_io.sam_header(gindex, config.command_line))
        chunks = stream_read_batches(r1_path, r2_path,
                                     config.num_reads_at_once,
                                     config.num_reads,
                                     pad_len=config.max_read_len,
                                     skip_reads=num_reads)
        # the span a profiler reads the device's busy share over
        with torch.profiler.record_function("chunk_loop"), \
                ChunkPipeline(config, db, entry_taxids, lca_tables,
                              mesh=mesh, sharded_db=sharded_db,
                              depth=depth, tail=tail) as pipe:
            for batch, packed in pipe.read(chunks, prepare):
                num_reads += batch.midpoint if batch.paired \
                    else batch.num_reads
                if not use_device:
                    handle_chunk(sam_file, batch,
                                 process_batch(batch, db, config), None,
                                 num_reads)
                    continue
                # the columnar classification needs no per-pair objects
                pipe.feed(batch, dict(
                    batch=batch, reads=num_reads,
                    want_objects=bool(sam_file) or config.just_align),
                    packed)
            pipe.drain()
    finally:
        if sam_file:
            sam_file.close()
    if ck is not None:
        ck.clear()
    metrics.log_summary()
    if config.just_align:
        log("Done")
        return
    with metrics.stage("write_results"):
        with open(out_path + "_PerRead", "w") as per_read:
            xml_results.write_per_read_results(identified, per_read)
        combined = classify.combine_taxonomies(identified)
        if out_path:
            with open(out_path, "w") as out:
                xml_results.write_results(combined, out, taxdb, num_reads)
            xml_results.write_abbreviated_results(
                combined, out_path + "_abbreviated", taxdb, num_reads)
        else:
            xml_results.write_results(combined, sys.stdout, taxdb,
                                      num_reads)
    log("Done")
