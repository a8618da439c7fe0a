"""Sharded alignment on a (data, index) mesh of torch devices.

Counterpart of kslam_tpu/parallel/dist.py (--mesh DxS, --shard-genomes).
The reference package runs one controller over Mesh("data", "index")
with shard_map; torch has neither, so this module keeps the same
single-controller design with its collectives written out:

  * a mesh is a [D, S] grid of torch devices (build_mesh); a device may
    hold several cells, so one card, or the CPU, can run any mesh shape,
    as the reference's virtual CPU devices do,
  * reads are split over the "data" axis (one sub-batch per data row),
  * the sorted k-mer index is range-sharded over the "index" axis
    (KmerIndex.shard_bounds: a range shard never splits a pileup; each
    shard derived on its cards by place_sharded_db), and each cell
    joins its data row's reads against its own shard, with the shard's
    own prefix table (the global one clipped to the shard's range) and
    the exact tier 2 of ops/match.expand_seeds,
  * the packed seed words of a data row are all-gathered over "index"
    onto the row's first device, merge-sorted and deduped there (exact:
    range shards never split a pileup and the sort erases shard order),
  * SW runs on each index shard's 1/S slice of the compacted rows, or,
    with --shard-genomes (genome_layout: shard_genomes' entry ranges),
    on the shard that owns the row's genome entry, against that shard's
    slice of the genome only,
  * the alignments are gathered back, and the score screen and pairing
    run per data row; split_phase_a hands the rows to the chunk-wide
    phase B (pipeline/device_path.run_chunk_phase_b) like device batches.

all_gather, psum and pmax are plain functions over the per-shard tensors:
each moves its shards to the target device and concatenates or reduces
them; no torch.distributed is used inside one process.

Shapes are dynamic, as everywhere in the port: each shard's expansion is
exact (ops/match.expand_seeds with no capacity) and entry-owner SW
aligns every owned row, so the reference's static caps (cap_local,
sw_batch divisible by S, sw_owner_cap) and its mesh overflow retry
(kslam_tpu/pipeline/run.py:352-378) have no counterpart here.  Nor has
its get_sharded_phase_a, a cache of compiled steps: a step here
compiles nothing, so callers build it per chunk.

SW uses the chunked window (ops/sw.align_overlaps_batch_chunked) on each
shard's genome chunk rows, the same call as the single-device phase A,
so every shard's rows go through the hand-written kernel at the main
path's shapes and the mesh needs no flat genome copy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..db import device_columns
from ..ops import kmers, match, sw
from ..pipeline import device_path
from ..utils import metrics


class Mesh(NamedTuple):
    """[D][S] grid of torch devices: cell (d, s) is devices[d][s]."""
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "index": len(self.devices[0])}

    def distinct(self) -> list:
        """The mesh's devices, each once, in cell order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


def _norm(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def local_devices(device) -> list:
    """The devices of the run's type this process sees: every visible
    CUDA device for a cuda run (CUDA_VISIBLE_DEVICES selects them per
    process), else the one CPU device."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def build_mesh(devices, data: int = 0, index: int = 0) -> Mesh:
    """Mesh over `devices`; defaults to (data=1, index=len(devices)).
    Cell i = d * index + s goes on devices[i % len(devices)]: with fewer
    devices than cells, the cells cycle over them."""
    devices = [_norm(d) for d in devices]
    if not data or not index:
        data, index = 1, len(devices)
    cells = [devices[i % len(devices)] for i in range(data * index)]
    return Mesh(tuple(tuple(cells[d * index:(d + 1) * index])
                      for d in range(data)))


def all_gather(xs, dev):
    """Concatenation of the per-shard tensors on `dev` (shard order)."""
    return torch.cat([x.to(dev) for x in xs])


def psum(xs, dev):
    """Sum of the per-shard tensors on `dev` (dtype kept)."""
    return functools.reduce(lambda a, b: a + b, (x.to(dev) for x in xs))


def pmax(xs, dev):
    """Elementwise max of the per-shard tensors on `dev`."""
    return functools.reduce(torch.maximum, (x.to(dev) for x in xs))


def _sync(mesh: Mesh) -> None:
    """Wait for every device of the mesh, so a host timer around a stage
    measures it."""
    for dev in mesh.distinct():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


class ShardedAlignResult(NamedTuple):
    """Per-cell overlap columns ([D][S] tuples of tensors, each on its
    cell's device; read ids global) and the per-read best score over all
    shards ([N] on the mesh's first device)."""
    read_id: tuple
    entry_id: tuple
    rel_pos: tuple
    rc: tuple
    valid: tuple
    score: tuple
    ref_begin: tuple
    ref_end: tuple
    query_begin: tuple
    query_end: tuple
    best_score: torch.Tensor


class ShardedDB(NamedTuple):
    """place_sharded_db result: the database tensors each mesh cell reads,
    as [D][S] tuples (cells on one device share one tensor)."""
    kmers: tuple          # int64 keys of index range shard s, padded
    idx_pack: tuple       # int64 entry<<33 | offset<<1 | rc of shard s
    genome_chunks: tuple  # uint8 [G/32, 32] SW codes: all, or slice s
    entry_offsets: tuple  # int64: global, or rebased to slice s
    e_bounds: Optional[np.ndarray]  # int32 [S+1] entry ranges of the
    # genome slices (None: genomes replicated)
    pstart: tuple         # int32 [2^bits + 1] prefix table of shard s
    prefix_bits: int      # (0: no table, pstart None, the exact search)
    prefix_window: int


def _reads_on(bases, lengths, window_len: int, nbits, kbits, dev):
    """A data row's reads on `dev`: (k-mers, offsets, rc, valid, SW
    codes, lengths)."""
    lengths = lengths.to(dev)
    kcodes, scodes = device_path.decode_reads(
        bases.to(dev), window_len,
        None if nbits is None else nbits.to(dev),
        None if kbits is None else kbits.to(dev))
    return kmers.read_kmers_from_codes(kcodes, lengths) + (scodes, lengths)


def make_sharded_align_step(mesh: Mesh, config: PipelineConfig,
                            window_len: int):
    """The multi-device alignment step (join, SW and the per-read best
    over index shards), without pairing.

    step(bases u8 [N, L] ASCII, lengths int32 [N], sharded_db): the N
    reads split into D equal row blocks; cell (d, s) joins block d
    against index shard s and aligns its own candidates.  Returns a
    ShardedAlignResult."""
    p = config.sw
    data, index = mesh.shape["data"], mesh.shape["index"]

    def step(bases, lengths, sdb: ShardedDB) -> ShardedAlignResult:
        bases, lengths = torch.as_tensor(bases), torch.as_tensor(lengths)
        n_local = bases.shape[0] // data
        dev0 = mesh.devices[0][0]
        cols = [[[None] * index for _ in range(data)] for _ in range(10)]
        best = []
        for d in range(data):
            rows = slice(d * n_local, (d + 1) * n_local)
            local_best = []
            for s, dev in enumerate(mesh.devices[d]):
                km, off, rc, valid, scodes, lens = _reads_on(
                    bases[rows], lengths[rows], window_len, None, None, dev)
                res = match.compact_overlaps(match.match_overlaps(
                    km, off, rc, valid, lens, sdb.kmers[d][s],
                    sdb.idx_pack[d][s]))
                al = sw.align_overlaps_batch_chunked(
                    res.read_id, res.entry_id, res.rel_pos, res.rc,
                    res.valid, scodes, lens, sdb.genome_chunks[d][s],
                    sdb.entry_offsets[d][s], p.match, p.mismatch,
                    p.gap_open, p.gap_extend, window_len=window_len)
                score = torch.where(res.valid, al.score, 0)
                # per-read best across index shards: local segment max,
                # then pmax over the data row's cells
                local_best.append(torch.zeros(
                    n_local, dtype=score.dtype, device=dev).scatter_reduce(
                        0, res.read_id.to(torch.int64), score, "amax"))
                gread = res.read_id + d * n_local
                for k, x in enumerate((gread, res.entry_id, res.rel_pos,
                                       res.rc, res.valid, score,
                                       al.ref_begin, al.ref_end,
                                       al.query_begin, al.query_end)):
                    cols[k][d][s] = x
            best.append(pmax(local_best, dev0))
        return ShardedAlignResult(
            *(tuple(tuple(row) for row in c) for c in cols),
            best_score=torch.cat(best))

    return step


def shard_genomes(entry_offsets: "np.ndarray", genome_scodes: "np.ndarray",
                  num_shards: int):
    """Entry-range partition of the genome codes so no device holds the
    whole database (SURVEY 5.7: config[3]'s ~50GB DB).  Entries are split
    into `num_shards` contiguous ranges balanced by total bases; each
    shard's base slice is padded to a common length and its entry offsets
    are rebased to the slice.

    Returns (scodes uint8 [S*Gper], offsets int64 [S*(Eper+1)],
    e_bounds int32 [S+1]); the first two split S-ways under P("index")."""
    import numpy as np
    num_entries = len(entry_offsets) - 1
    total = int(entry_offsets[-1])
    targets = (np.arange(1, num_shards) * total) // num_shards
    cuts = np.searchsorted(entry_offsets, targets, side="left")
    e_bounds = np.concatenate([[0], cuts, [num_entries]]).astype(np.int32)
    e_bounds = np.maximum.accumulate(e_bounds)
    g_per = max(int(np.max(entry_offsets[e_bounds[1:]] -
                           entry_offsets[e_bounds[:-1]])), 1)
    e_per = max(int(np.max(e_bounds[1:] - e_bounds[:-1])), 1)
    scodes = np.full((num_shards, g_per), 4, np.uint8)   # 4 = N
    offsets = np.zeros((num_shards, e_per + 1), np.int64)
    for s in range(num_shards):
        lo, hi = int(e_bounds[s]), int(e_bounds[s + 1])
        glo, ghi = int(entry_offsets[lo]), int(entry_offsets[hi])
        scodes[s, :ghi - glo] = genome_scodes[glo:ghi]
        k = hi - lo
        offsets[s, :k + 1] = entry_offsets[lo:hi + 1] - glo
        offsets[s, k + 1:] = offsets[s, k]   # empty padding entries
    return scodes.reshape(-1), offsets.reshape(-1), e_bounds


def make_sharded_phase_a(mesh: Mesh, *, paired: bool, match_s: int,
                         mismatch: int, gap_open: int, gap_extend: int,
                         window_len: int, score_threshold: int = 0,
                         genome_sharded: bool = False):
    """The full phase A of the device pipeline on a (data, index) mesh.

    For each data row d, with dev0 its first cell's device:
      1. each cell (d, s) unpacks row d's reads (once per distinct
         device) and expands their seed pairs against index shard s
         (ops/match.expand_seeds: the shard's prefix window and the
         exact tier 2),
      2. the packed candidate words are all-gathered onto dev0, merge
         sorted and deduped (ops/match.finish_overlaps) and compacted,
      3. SW: without genome sharding, cell (d, s) aligns the s-th of S
         contiguous slices of the compacted rows and the results are
         gathered back in row order; with genome_sharded, cell (d, s)
         aligns the rows whose entry lies in [e_bounds[s], e_bounds[s+1])
         against its genome slice (entry ids rebased), and each row's
         result is combined from its one owner by psum (entry-owner
         routing),
      4. the score screen and the pairing sweep run on dev0.

    step(bases, lengths, midpoint, sharded_db, nbits=None, kbits=None):
    bases u8 [D*rows, L] (ASCII, or with nbits/kbits the packed 2-bit
    plane of encode.pack_reads_np and its sidecars) and lengths int32
    [D*rows] stack the D sub-batches; midpoint is every sub-batch's
    local first R2 row.  Returns one device_path.PhaseAOut per data row,
    on that row's first device."""
    data, index = mesh.shape["data"], mesh.shape["index"]

    def shard_sw(res: match.Overlaps, sdb: ShardedDB, d: int, s: int,
                 reads) -> sw.SWAlignments:
        """Cell (d, s)'s part of row d's SW, on the cell's device.
        Without genome sharding: the s-th of S contiguous slices of the
        compacted rows (concatenated back in row order).  With genome
        sharding: every row, 0 where shard s does not own the row's
        entry (each row has exactly one owner, so a psum combines
        them)."""
        dev = mesh.devices[d][s]
        n = res.read_id.shape[0]
        if genome_sharded:
            e_lo, e_hi = int(sdb.e_bounds[s]), int(sdb.e_bounds[s + 1])
            sel = torch.nonzero((res.entry_id >= e_lo) &
                                (res.entry_id < e_hi)).reshape(-1)
            entry = res.entry_id[sel] - e_lo
        else:
            per = -(-n // index)
            sel = torch.arange(min(s * per, n), min((s + 1) * per, n),
                               device=res.read_id.device)
            entry = res.entry_id[sel]
        if len(sel):
            al = sw.align_overlaps_batch_chunked(
                res.read_id[sel].to(dev), entry.to(dev),
                res.rel_pos[sel].to(dev), res.rc[sel].to(dev),
                res.valid[sel].to(dev), reads[4], reads[5],
                sdb.genome_chunks[d][s], sdb.entry_offsets[d][s], match_s,
                mismatch, gap_open, gap_extend, window_len=window_len)
        else:
            z = torch.zeros(0, dtype=torch.int32, device=dev)
            al = sw.SWAlignments(z, z, z, z, z)
        if not genome_sharded:
            return al
        sel = sel.to(dev)
        return sw.SWAlignments(*(torch.zeros(n, dtype=x.dtype, device=dev)
                                 .index_put((sel,), x) for x in al))

    def step(bases, lengths, midpoint, sdb: ShardedDB, nbits=None,
             kbits=None):
        bases, lengths = torch.as_tensor(bases), torch.as_tensor(lengths)
        if nbits is not None:
            nbits, kbits = torch.as_tensor(nbits), torch.as_tensor(kbits)
        n_local = bases.shape[0] // data
        outs = []
        for d in range(data):
            cells = mesh.devices[d]
            dev0 = cells[0]
            rows = slice(d * n_local, (d + 1) * n_local)
            with metrics.stage("mesh_join"):
                reads = {dev: _reads_on(
                    bases[rows], lengths[rows], window_len,
                    None if nbits is None else nbits[rows],
                    None if kbits is None else kbits[rows], dev)
                    for dev in dict.fromkeys(cells)}
                seeds = [match.expand_seeds(
                    *reads[dev][:4], reads[dev][5], sdb.kmers[d][s],
                    sdb.idx_pack[d][s], idx_pstart=sdb.pstart[d][s],
                    prefix_bits=sdb.prefix_bits,
                    window=sdb.prefix_window)
                    for s, dev in enumerate(cells)]
                _sync(mesh)
            with metrics.stage("mesh_merge"):
                res = match.compact_overlaps(match.finish_overlaps(
                    all_gather([x[0] for x in seeds], dev0),
                    all_gather([x[1] for x in seeds], dev0),
                    psum([x[2] for x in seeds], dev0),
                    psum([x[3] for x in seeds], dev0),
                    pmax([x[4] for x in seeds], dev0)))
                _sync(mesh)
            with metrics.stage("mesh_sw"):
                parts = [shard_sw(res, sdb, d, s, reads[dev])
                         for s, dev in enumerate(cells)]
                _sync(mesh)
            with metrics.stage("mesh_gather_back"):
                combine = psum if genome_sharded else all_gather
                al = sw.SWAlignments(*(combine([p[k] for p in parts], dev0)
                                       for k in range(5)))
                _sync(mesh)
            with metrics.stage("mesh_pair"):
                outs.append(device_path.screen_and_pair(
                    res, al, reads[dev0][5], midpoint, score_threshold,
                    paired))
                _sync(mesh)
        return outs

    return step


def place_sharded_db(mesh: Mesh, kidx, bases, entry_offsets_np,
                     genome_sharded: bool = False) -> ShardedDB:
    """Derives on the devices of the mesh what shard_database(kidx, S,
    with_prefix=True) + index_words_np and genome_chunks_from_scodes of
    the SW codes of `bases` (ASCII, [G]) would give each cell, from the
    slices of the loaded columns (db/device_columns.py): index range
    shard s (kidx.shard_bounds) goes to the devices of its index column,
    its keys and idx_pack sentinel-padded there, with its clipped prefix
    table; the genome rows and offsets go to every device (replicated)
    or, with genome_sharded, each entry-range slice (genome_layout) to
    the devices of its column.  The prefix table's counts at each width
    are the sum of the shards' counts, each counted on its own device
    (shards split the sorted range, so the sums are exact), and shard
    s's pstart is clip(pstart - lo, 0, hi - lo) of the global table.
    Each distinct tensor is derived once on each distinct device: on one
    card a replicated genome is one tensor, not one per cell.  Per-chunk
    steps then move no database bytes."""
    index = mesh.shape["index"]
    bounds = kidx.shard_bounds(index)
    span = [(int(bounds[s]), int(bounds[s + 1])) for s in range(index)]
    devs = [list(dict.fromkeys(row[s] for row in mesh.devices))
            for s in range(index)]
    raw = {(s, dev): device_columns.upload_keys(
        kidx.kmers[lo:hi], dev, shard_cap(bounds, device_columns.MAX_WINDOW))
        for s, (lo, hi) in enumerate(span) for dev in devs[s]}
    dev0 = mesh.devices[0][0]

    def counts_of(bits):
        return sum(device_columns.prefix_counts(
            raw[(s, devs[s][0])][:hi - lo], bits).to(dev0)
            for s, (lo, hi) in enumerate(span))
    g_pstart, bits, window = device_columns.choose_prefix(
        counts_of, len(kidx.kmers))
    per = shard_cap(bounds, window)
    placed = {}
    for s, (lo, hi) in enumerate(span):
        for dev in devs[s]:
            keys = device_columns.seal_keys(raw.pop((s, dev)), hi - lo, per)
            pack = device_columns.pack_column(
                kidx.entry_id[lo:hi], kidx.offset[lo:hi], kidx.rc[lo:hi],
                per, dev)
            pstart = None if g_pstart is None else (
                g_pstart.to(dev).to(torch.int64) - lo).clamp_(
                    0, hi - lo).to(torch.int32)
            placed[("index", s, dev)] = (keys, pack, pstart)
    del g_pstart
    if genome_sharded:
        e_bounds, g_per, offsets = genome_layout(
            np.asarray(entry_offsets_np), index)
        starts = np.asarray(entry_offsets_np)[e_bounds]
        genome = lambda s, dev: (device_columns.genome_rows(
            bases[starts[s]:starts[s + 1]], dev, length=g_per),
            torch.as_tensor(offsets[s]).to(dev))
    else:
        e_bounds = None
        offsets = np.asarray(entry_offsets_np, np.int64)
        genome = lambda s, dev: (device_columns.genome_rows(bases, dev),
                                 torch.as_tensor(offsets).to(dev))
    for s in range(index):
        for dev in devs[s]:
            key = ("genome", s if genome_sharded else 0, dev)
            if key not in placed:
                placed[key] = genome(s, dev)
    cells = [[(placed[("index", s, dev)],
               placed[("genome", s if genome_sharded else 0, dev)])
              for s, dev in enumerate(row)] for row in mesh.devices]
    grid = lambda f: tuple(tuple(f(c) for c in row) for row in cells)
    return ShardedDB(kmers=grid(lambda c: c[0][0]),
                     idx_pack=grid(lambda c: c[0][1]),
                     genome_chunks=grid(lambda c: c[1][0]),
                     entry_offsets=grid(lambda c: c[1][1]),
                     e_bounds=e_bounds,
                     pstart=grid(lambda c: c[0][2]),
                     prefix_bits=bits, prefix_window=window)


def shard_cap(bounds, window: int) -> int:
    """shard_database's padded shard length for shard `bounds` and the
    prefix window: pow2(max(longest shard, 16) + 2*window)."""
    per = max(int(np.max(bounds[1:] - bounds[:-1])), 16) + 2 * window
    return 1 << (per - 1).bit_length()


def genome_layout(entry_offsets: np.ndarray, num_shards: int):
    """shard_genomes' layout without its copy of the codes: (e_bounds
    int32 [S+1], the padded slice length g_per, offsets int64 [S,
    Eper+1] rebased to each slice).  Slice s of the genome is
    [entry_offsets[e_bounds[s]], entry_offsets[e_bounds[s+1]])."""
    num_entries = len(entry_offsets) - 1
    total = int(entry_offsets[-1])
    targets = (np.arange(1, num_shards) * total) // num_shards
    cuts = np.searchsorted(entry_offsets, targets, side="left")
    e_bounds = np.concatenate([[0], cuts, [num_entries]]).astype(np.int32)
    e_bounds = np.maximum.accumulate(e_bounds)
    g_per = max(int(np.max(entry_offsets[e_bounds[1:]] -
                           entry_offsets[e_bounds[:-1]])), 1)
    e_per = max(int(np.max(e_bounds[1:] - e_bounds[:-1])), 1)
    offsets = np.zeros((num_shards, e_per + 1), np.int64)
    for s in range(num_shards):
        lo, hi = int(e_bounds[s]), int(e_bounds[s + 1])
        k = hi - lo
        offsets[s, :k + 1] = entry_offsets[lo:hi + 1] - entry_offsets[lo]
        offsets[s, k + 1:] = offsets[s, k]   # empty padding entries
    return e_bounds, g_per, offsets


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return type(x)(*(_to(v, dev) for v in x))
    return x


def split_phase_a(outs, mesh: Mesh):
    """The per-data-row PhaseAOut's of a sharded step, moved onto the
    mesh's first device, where the chunk-wide phase B
    (device_path.run_chunk_phase_b) consumes them like device batches."""
    dev0 = mesh.devices[0][0]
    return [_to(a, dev0) for a in outs]


def shard_database(kidx, num_shards: int, with_prefix: bool = False):
    """Pads + partitions the sorted k-mer index into equal device slices
    that respect pileup boundaries.  Returns stacked-then-flattened arrays
    whose equal S-way split reproduces the range shards.

    with_prefix=True additionally builds per-shard prefix
    direct-addressing tables (db/kmer_index.prefix_table clipped to each
    shard's range: out-of-range prefixes collapse to empty windows) and
    returns (km, eid, off, rc, pstart [S*(2^bits+1)], bits, window);
    bits == 0 means no table (fall back to the blocked search)."""
    import numpy as np
    bounds = kidx.shard_bounds(num_shards)
    per = max(int(np.max(bounds[1:] - bounds[:-1])), 16)
    g_pstart, bits, window = kidx.prefix_table() if with_prefix \
        else (None, 0, 0)
    if g_pstart is None:
        bits = window = 0
    if window:
        # the prefix lookup reads aligned [window] rows r and r+1 past the
        # run start, so every shard needs >= 2*window sentinel tail
        per += 2 * window
    per = 1 << (per - 1).bit_length()
    km = np.full((num_shards, per), np.uint64(2 ** 64 - 1), dtype=np.uint64)
    eid = np.zeros((num_shards, per), np.int32)
    off = np.zeros((num_shards, per), np.int32)
    rc = np.zeros((num_shards, per), bool)
    pstart = np.zeros((num_shards, (1 << bits) + 1), np.int32) \
        if bits else None
    for s in range(num_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        km[s, :hi - lo] = kidx.kmers[lo:hi]
        eid[s, :hi - lo] = kidx.entry_id[lo:hi]
        off[s, :hi - lo] = kidx.offset[lo:hi]
        rc[s, :hi - lo] = kidx.rc[lo:hi]
        if bits:
            pstart[s] = np.clip(g_pstart.astype(np.int64) - lo, 0, hi - lo)
    flat = (km.reshape(-1), eid.reshape(-1), off.reshape(-1),
            rc.reshape(-1))
    if with_prefix:
        return flat + (pstart.reshape(-1) if bits else None, bits, window)
    return flat
