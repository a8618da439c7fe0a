"""Multi-process execution: chunk-parallel classification over
torch.distributed (gloo).

Counterpart of kslam_tpu/parallel/multihost.py, with the same layout:

  * WITHIN a process: the device pipeline (pipeline/run.process_chunk);
    a process that sees more than one device (CUDA_VISIBLE_DEVICES set
    per process by the caller) range-shards the index over them on a
    local (data=1, index=L) mesh (parallel/dist.py), or on the --mesh
    shape; --device-pipeline off runs the host-object pipeline.
  * ACROSS processes: pure data parallelism over FASTQ chunks.  Process
    p of P takes chunks p, p+P, p+2P, ... of the --num-reads-at-once
    stream; nothing crosses processes during alignment.
  * MERGE: per-chunk taxonomies are all-gathered to every process
    (all_gather_object over gloo), and process 0 writes the combined
    XML/TSV outputs.  SAM output goes to per-process `<sam>.partN`
    files, which process 0 concatenates (one header) at the end.

Process 0 hosts the gloo store at the coordinator address.  Every
collective has a finite timeout (PEER_TIMEOUT), so a dead or hung peer
fails the run instead of hanging it.

Usage (one command per process):
  python -m kslam_tpu_torch.cli ... --coordinator HOST:PORT \\
      --num-processes P --process-id N
"""

from __future__ import annotations

import datetime
from typing import List, Optional

import torch

from ..utils.logging import log

PEER_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(coordinator: str, num_processes: int, process_id: int,
               device) -> None:
    import torch.distributed as tdist
    from .dist import local_devices
    tdist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                             world_size=num_processes, rank=process_id,
                             timeout=PEER_TIMEOUT)
    n_local = len(local_devices(device))
    log(f"distributed: process {process_id}/{num_processes}, "
        f"{n_local} local / {gather_sum(n_local)} global devices")


def shutdown() -> None:
    import torch.distributed as tdist
    if tdist.is_initialized():
        tdist.destroy_process_group()


def _world() -> int:
    import torch.distributed as tdist
    return tdist.get_world_size() if tdist.is_initialized() else 1


def gather_objects(objs: List) -> List:
    """All-gathers a list of picklable objects across processes; returns
    the concatenated list (same order on every process: by process id)."""
    import torch.distributed as tdist
    if _world() == 1:
        return list(objs)
    parts = [None] * _world()
    tdist.all_gather_object(parts, list(objs))
    return [x for part in parts for x in part]


def gather_sum(value: int) -> int:
    import torch.distributed as tdist
    if _world() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64)
    tdist.all_reduce(t)
    return int(t[0])


def strided_chunks(batches, process_id: int, num_processes: int):
    """Process p consumes chunks p, p+P, ... of the chunk stream."""
    for i, batch in enumerate(batches):
        if i % num_processes == process_id:
            yield i, batch


def concat_sam_parts(sam_path: str, num_parts: int) -> None:
    """Merge per-process `<sam>.partN` files into one SAM at sam_path:
    part 0 verbatim (it carries the header), later parts with their
    header (@-prefixed) lines stripped -- one @HD/@SQ/@PG block total,
    like the reference's single-process output (SAM.h:513-531)."""
    import os
    with open(sam_path, "wb") as out:
        for p in range(num_parts):
            part = f"{sam_path}.part{p}"
            with open(part, "rb") as fh:
                for line in fh:
                    if p > 0 and line.startswith(b"@"):
                        continue
                    out.write(line)
            os.remove(part)


def metagenomic_analysis_distributed(r1_path: str, r2_path: Optional[str],
                                     database_dir: str, out_path: str,
                                     sam_path: str, config, device) -> None:
    """Distributed variant of pipeline.run.metagenomic_analysis."""
    import torch.distributed as tdist
    from ..db.genbank import GenbankIndex
    from ..db.kmer_index import KmerIndex
    from ..db.taxonomy import TaxonomyDB
    from ..io import sam as sam_io
    from ..io import xml_results
    from ..io.fastq import stream_read_batches
    from ..ops.sw import check_params
    from ..pipeline import align, classify
    from ..io import sam_columns
    from ..pipeline.run import (chunk_objects, device_tables, process_batch,
                                process_chunk)
    from . import dist

    pid, nproc = tdist.get_rank(), tdist.get_world_size()
    check_params(config.sw)
    config.paired_data = bool(r2_path)
    taxdb = TaxonomyDB.read_index(f"{database_dir}/taxDB") \
        if not config.just_align else TaxonomyDB()
    gindex = GenbankIndex.load(database_dir)
    kidx = KmerIndex.load(database_dir)

    # every process runs the device pipeline on its LOCAL devices: the
    # k-mer index is range-sharded over them via a local (data=1,
    # index=L) mesh unless the user pins a mesh shape or disables the
    # device path
    use_device = config.device_pipeline != "off"
    db = mesh = sharded_db = None
    entry_taxids = lca_tables = None
    if use_device:
        local = dist.local_devices(device)
        if config.mesh_shape:
            d_axis, s_axis = (int(x) for x in config.mesh_shape.split("x"))
        else:
            d_axis, s_axis = 1, len(local)
        if d_axis * s_axis > 1:
            mesh = dist.build_mesh(local, data=d_axis, index=s_axis)
            sharded_db = dist.place_sharded_db(
                mesh, kidx, gindex.bases_concat, gindex.entry_offsets,
                genome_sharded=config.genome_sharded)
            log(f"[p{pid}] local mesh (data={d_axis}, index={s_axis})")
        entry_taxids, lca_tables = device_tables(
            gindex, taxdb, device if mesh is None else mesh.devices[0][0])
    if mesh is None:
        db = align.DeviceDB.from_index(gindex, kidx, device,
                                       flat_scodes=not use_device)

    sam_file = None
    if sam_path:
        config.report_cigar = True
        suffix = f".part{pid}" if nproc > 1 else ""
        sam_file = open(sam_path + suffix, "w")
        sam_file.write(sam_io.sam_header(gindex, config.command_line))

    # identified: list of (chunk_index, block) where a block is a compact
    # columnar ChunkTaxa (device path without SAM) or a list of per-read
    # IdentifiedTaxonomy objects (host/SAM paths), so the merge moves
    # names and a taxid array, not per-read objects
    identified: List = []
    local_reads = 0
    stream = stream_read_batches(r1_path, r2_path, config.num_reads_at_once,
                                 config.num_reads,
                                 pad_len=config.max_read_len)
    try:
        for chunk_i, batch in strided_chunks(stream, pid, nproc):
            local_reads += batch.midpoint if batch.paired \
                else batch.num_reads
            columnar = use_device and not sam_file and not config.just_align
            if use_device:
                b, ov_cols = process_chunk(batch, db, config, entry_taxids,
                                           lca_tables, mesh=mesh,
                                           sharded_db=sharded_db)
                reads_and_pairs = None if columnar else \
                    chunk_objects(b, ov_cols, batch)
            else:
                reads_and_pairs = process_batch(batch, db, config)
            if sam_file:
                sam_columns.write_sam(sam_file, reads_and_pairs, batch,
                                      gindex, config, device)
            if not config.just_align:
                if columnar:
                    identified.append(
                        (chunk_i, classify.chunk_taxa_from_arrays(
                            classify.fetch_classify_arrays(b), batch.names,
                            gindex)))
                else:
                    identified.append(
                        (chunk_i, classify.convert_alignments_to_taxonomies(
                            reads_and_pairs, gindex, batch.names, taxdb)))
            log(f"[p{pid}] processed {local_reads} reads")
    finally:
        if sam_file:
            sam_file.close()
    if config.just_align:
        if sam_path and nproc > 1:
            gather_sum(0)      # barrier: every process closed its part
            if pid == 0:
                concat_sam_parts(sam_path, nproc)
        return

    # gather compact blocks, restore global chunk order (processes hold
    # strided chunks, so a plain by-process concat would interleave them
    # out of stream order)
    n_blk = sum(1 for _, b in identified
                if isinstance(b, classify.ChunkTaxa))
    log(f"[p{pid}] gathering {n_blk}/{len(identified)} columnar blocks")
    gathered = gather_objects(identified)
    gathered.sort(key=lambda t: t[0])
    all_identified: List = []
    for _, block in gathered:
        if isinstance(block, classify.ChunkTaxa):
            all_identified.append(block)
        else:
            all_identified.extend(block)
    total_reads = gather_sum(local_reads)
    if sam_path and nproc > 1 and pid == 0:
        concat_sam_parts(sam_path, nproc)
    if pid == 0:
        with open(out_path + "_PerRead", "w") as per_read:
            xml_results.write_per_read_results(all_identified, per_read)
        combined = classify.combine_taxonomies(all_identified)
        with open(out_path, "w") as out:
            xml_results.write_results(combined, out, taxdb, total_reads)
        xml_results.write_abbreviated_results(
            combined, out_path + "_abbreviated", taxdb, total_reads)
    log("Done")
