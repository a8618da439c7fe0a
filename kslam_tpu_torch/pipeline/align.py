"""Device-resident database tensors, the host-object alignment stage and
the deferred SAM cigars.

Counterpart of kslam_tpu/pipeline/align.py.  DeviceDB holds what the
join and the SW window builders read: the sorted k-mer keys
(ops/kmers.py key encoding) and the per-slot entry|offset|rc word, both
sentinel-padded, the join's tables (the prefix table and, unless
--no-prefix-rows, the sector table, built on the device from the keys
at load: db/sector_table.py), the genome codes as [G/32, 32] rows, the
entry offsets and, for the host-object path only (--device-pipeline
off), the flat [G] genome codes, all derived on the device from the
loaded index (db/device_columns.py).  The join's tier 2
is exact (ops/match.expand_seeds), so align_batch_to_database needs no
overflow retry.

Cigars are not computed at alignment time: SAM output needs them only
for the top numSAMAlignments survivors per read, which
compute_cigars_batch (native csrc/ssw_batch.cc) or compute_overlap_cigar
(the golden scalar model) fill at SAM-write time -- identical output,
far less work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import List

import numpy as np
import torch

from ..config import PipelineConfig
from ..db import device_columns, sector_table
from ..db.genbank import GenbankIndex
from ..db.kmer_index import KmerIndex
from ..golden import ssw as golden_ssw
from ..io.fastq import ReadBatch
from ..ops import encode, kmers, match, sw
from ..utils import metrics
from .pairing import AlignedOverlap


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


@dataclasses.dataclass
class DeviceDB:
    """Database tensors on one device."""
    kmers: torch.Tensor          # int64 [M'] sorted keys, sentinel-padded
    idx_pack: torch.Tensor       # int64 [M'] entry<<33 | offset<<1 | rc
    genome_chunks: torch.Tensor  # uint8 [G/32, 32] SW codes, N-padded
    entry_offsets: torch.Tensor  # int64 [E + 1]
    genome_scodes: torch.Tensor = None  # uint8 [G] (host-object path)
    pstart: torch.Tensor = None  # int32 [2^bits + 1] prefix table
    prefix_bits: int = 0         # (db/kmer_index.prefix_table);
    prefix_window: int = 0       # 0 bits = exact search
    sector: torch.Tensor = None  # int32 [2^b, 8] one-sector join rows
    sector_bits: int = 0         # (db/sector_table.py)

    @classmethod
    def from_index(cls, gindex: GenbankIndex, kidx: KmerIndex,
                   device, flat_scodes: bool = False,
                   prefix_rows: bool = True) -> "DeviceDB":
        """Tensors on `device` from the host index objects (the same
        GenbankIndex / KmerIndex the reference package loads), derived
        there from the raw columns and bases (db/device_columns.py: equal
        to join_columns and the host SW code rows).
        flat_scodes adds the flat [G] genome codes that only the
        host-object path's window gather reads: a view of the rows'
        buffer.  The sector table is built on `device` from the keys
        (sector_table.build at sector_table.default_bits); nothing of
        it is read from or written to the DB directory.
        prefix_rows=False skips it: the join is then the prefix window
        on pstart.  Four stages time the load, each ending in a device
        synchronisation: db_load_host (the host arrays the copies read),
        db_load_h2d (the staged copies, idx_pack formed from each staged
        chunk as it lands), db_load_columns (the keys' top bit, the
        sentinels, the prefix table and the SW codes, on the device) and
        db_load_table (the sector table)."""
        dev = torch.device(device)
        stage = functools.partial(_timed, dev=dev)
        with stage("db_load_host"):
            bases = gindex.bases_concat
            offsets = np.asarray(gindex.entry_offsets, np.int64)
        keys, pack, pstart, bits, window = device_columns.index_columns(
            kidx, dev, stage)
        rows = device_columns.genome_rows(bases, dev, flat=flat_scodes,
                                          stage=stage)
        with stage("db_load_h2d"):
            d_offsets = torch.as_tensor(offsets).to(dev)
        db = cls(kmers=keys, idx_pack=pack,
                 genome_chunks=rows[0] if flat_scodes else rows,
                 entry_offsets=d_offsets,
                 genome_scodes=rows[1] if flat_scodes else None,
                 pstart=pstart, prefix_bits=bits, prefix_window=window)
        if prefix_rows and len(kidx):
            with stage("db_load_table"):
                db.sector_bits = sector_table.default_bits(len(kidx))
                db.sector = sector_table.build(db.kmers, len(kidx),
                                               db.sector_bits)
        return db

    def join_tables(self) -> dict:
        """The join's table arguments of ops/match.expand_seeds."""
        return dict(idx_pstart=self.pstart, prefix_bits=self.prefix_bits,
                    window=self.prefix_window, idx_sector=self.sector,
                    sector_bits=self.sector_bits)


@contextlib.contextmanager
def _timed(name: str, dev):
    """metrics.stage(name) ending in a synchronisation of `dev` (its
    queued work is then in the stage's time)."""
    with metrics.stage(name):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def align_batch_to_database(batch: ReadBatch, db: DeviceDB,
                            config: PipelineConfig,
                            sw_chunk: int = 1 << 15) -> List[AlignedOverlap]:
    """Returns score-screened AlignedOverlaps (cigar=None) in sorted
    order (read, entry, relPos, rc), on the device of `db`.

    Applies screenOverlapsByScoreThreshold (Overlap.h:329-341): drops
    alignments with sw_score < scoreThreshold (score 0 survives the
    default threshold 0 exactly like the reference).  SW runs on the flat
    window (ops/sw.align_overlaps_batch) in chunks of sw_chunk rows, each
    padded to a power of two as in the reference package."""
    if db.genome_scodes is None:
        raise ValueError("the host-object path needs the flat genome "
                         "codes: DeviceDB.from_index(..., flat_scodes=True)")
    dev = db.kmers.device
    n = batch.num_reads
    n_pad = max(_next_pow2(n), 16)
    l = config.max_read_len
    bases = np.zeros((n_pad, l), dtype=np.uint8)
    lengths = np.zeros(n_pad, dtype=np.int32)
    bl = min(batch.bases.shape[1], l)
    bases[:n, :bl] = batch.bases[:, :bl]
    lengths[:n] = batch.lengths
    d_bases = torch.as_tensor(bases).to(dev)
    d_lengths = torch.as_tensor(lengths).to(dev)

    km, off, rc, valid = kmers.read_kmers_from_codes(
        encode.kmer_codes(d_bases), d_lengths)
    # the join and its tier 2 are exact and nothing is capped, so there
    # is no emit-all retry
    result = match.compact_overlaps(match.match_overlaps(
        km, off, rc, valid, d_lengths, db.kmers, db.idx_pack,
        **db.join_tables()))
    count = int(result.count)
    if not count:
        return []
    read_scodes = encode.sw_codes(d_bases)
    p = config.sw
    cols = [[] for _ in range(5)]
    for start in range(0, count, sw_chunk):
        stop = min(start + sw_chunk, count)
        pad = _next_pow2(max(stop - start, 16))
        sel = torch.zeros(pad, dtype=torch.int64, device=dev)
        sel[:stop - start] = torch.arange(start, stop, device=dev)
        al = sw.align_overlaps_batch(
            result.read_id[sel], result.entry_id[sel], result.rel_pos[sel],
            result.rc[sel], torch.ones(pad, dtype=torch.bool, device=dev),
            read_scodes, d_lengths, db.genome_scodes, db.entry_offsets,
            p.match, p.mismatch, p.gap_open, p.gap_extend, window_len=l)
        for c, x in zip(cols, al):
            c.append(x[:stop - start])
    host = torch.stack(
        [result.read_id, result.entry_id, result.rel_pos,
         result.rc.to(torch.int32)] + [torch.cat(c) for c in cols]
    ).cpu().numpy()
    (read_id, entry_id, rel_pos, rc_arr, scores, ref_begin, ref_end,
     query_begin, query_end) = host

    survivors = scores >= config.score_threshold
    out: List[AlignedOverlap] = []
    for k in np.flatnonzero(survivors):
        out.append(AlignedOverlap(
            read_id=int(read_id[k]), entry_id=int(entry_id[k]),
            rel_pos=int(rel_pos[k]), rc=bool(rc_arr[k]),
            score=int(scores[k]), ref_begin=int(ref_begin[k]),
            ref_end=int(ref_end[k]), query_begin=int(query_begin[k]),
            query_end=int(query_end[k])))
    return out


def compute_cigars_batch(overlaps: List[AlignedOverlap], batch: ReadBatch,
                         gindex: GenbankIndex,
                         config: PipelineConfig) -> bool:
    """Fills .cigar on every overlap via ONE native batched SSW+traceback
    call (csrc/ssw_batch.cc, OpenMP over overlaps) -- the device-era
    replacement for the reference's per-overlap banded_sw (ssw.c:594-792).
    Returns False when the native library is unavailable (callers fall back
    to the per-overlap golden path)."""
    from ..io import native
    todo = [o for o in overlaps if o.cigar is None]
    if not todo:
        return True
    n = len(todo)
    cols = {
        "read_id": np.fromiter((o.read_id for o in todo), np.int32, n),
        "entry_id": np.fromiter((o.entry_id for o in todo), np.int32, n),
        "rel_pos": np.fromiter((o.rel_pos for o in todo), np.int32, n),
        "rc": np.fromiter((o.rc for o in todo), np.uint8, n),
    }
    out = native.ssw_cigar_batch(
        batch.bases, batch.lengths, gindex.bases_concat,
        gindex.entry_offsets.astype(np.int64), cols["read_id"],
        cols["entry_id"], cols["rel_pos"], cols["rc"], config.sw,
        score_filter=config.score_threshold)
    if out is None:
        return False
    for k, o in enumerate(todo):
        c = native.unpack_cigar(out["cigar_buf"][k], out["cigar_len"][k])
        o.cigar = c if c is not None else []
    return True


def compute_overlap_cigar(overlap: AlignedOverlap, read_bases: str,
                          entry_bases: str, config: PipelineConfig) -> None:
    """Fills overlap.cigar lazily (deferred banded traceback; see module
    docstring).  Mirrors the reference's per-overlap cigar exactly by
    rerunning the golden scalar alignment with report_cigar."""
    if overlap.cigar is not None:
        return
    q = encode.sw_codes_np(encode.encode_seq(read_bases))
    g = encode.sw_codes_np(encode.encode_seq(entry_bases))
    al = golden_ssw.slam_overlap_align(
        q, g, overlap.rel_pos, overlap.rc, config.sw, report_cigar=True,
        score_filter=config.score_threshold)
    overlap.cigar = al.cigar if al.cigar is not None else []
