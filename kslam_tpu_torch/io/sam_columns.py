"""A chunk's SAM text from columns: the port's replacement for
pipeline/run._fill_cigars followed by io/sam.write_sam_pairs per read.

  1. collect: per read, the pairs after the stable sort by
     -combined_score that both of those do (in place, as they do), the
     first num_sam_alignments of them written, and each r1/r2 overlap of
     those pairs once (an overlap can stand in several pairs; its diff is
     a function of the overlap alone), as columns;
  2. launch: ops/sam_cuda.sam_cigar on each overlap's native window (the
     cigar compute_cigars_batch's native call gives), then sam_cuda.sam_diff
     from the overlap's own ref_begin / query_begin / query_end (the
     CIGAR and MD texts, NM and the log10 probability of get_cigar_and_md);
  3. fetch the columns once (and once more for the rare rows whose texts
     or reference window were too short, relaunched wider);
  4. write: the lines of sam_from_pair / write_sam_pairs (flags, mirroring,
     tlen, the gene tags, XS, X0, MAPQ, --sam-xa), each entry fed the
     fetched CIGAR, MD, NM and prob = 10 ** log10 probability.

On a CUDA device the kernels run on a stream of this module's own, so
that the chunk pipeline's tail overlaps the next chunk's device work on
the calling thread's stream; the inputs are host arrays uploaded on that
stream, and the fetch waits on an event recorded there, not on the
device.  On the CPU the kernels' plain versions run.  Nothing here calls
the native cigar call, get_cigar_and_md or the plain versions on a card.
"""

from __future__ import annotations

import math
import threading
from typing import List

import numpy as np
import torch

from ..ops import sam_cuda
from ..utils import metrics
from .sam import SAMEntry

_STREAMS = {}
_STREAMS_LOCK = threading.Lock()
WINDOW_PAD = 16       # reference bytes past the read's length, first launch


def _side_stream(device: torch.device):
    with _STREAMS_LOCK:
        key = device.index if device.index is not None else \
            torch.cuda.current_device()
        if key not in _STREAMS:
            _STREAMS[key] = torch.cuda.Stream(device=key)
        return _STREAMS[key]


def collect(reads_and_pairs, config):
    """(per read, the pairs written; the overlaps, each once; a bool per
    overlap: it stands in one of the first num_sam_alignments pairs of a
    read, the pairs _fill_cigars gives a cigar).  Sorts each read's pairs
    as _fill_cigars and write_sam_pairs do."""
    written, overlaps, filled = [], [], []
    index = {}
    cap = config.num_sam_alignments
    for read in reads_and_pairs:
        read.pairs.sort(key=lambda p: -p.combined_score)
        if not read.pairs:
            written.append(())
            continue
        # write_sam_pairs writes at least one pair, _fill_cigars fills
        # the first `cap`
        top = read.pairs[:max(cap, 1)]
        written.append(top)
        for at, pair in enumerate(top):
            for o in (pair.r1, pair.r2):
                if o is None:
                    continue
                k = index.get(id(o))
                if k is None:
                    k = index[id(o)] = len(overlaps)
                    overlaps.append(o)
                    filled.append(False)
                filled[k] = filled[k] or at < cap
    return written, overlaps, np.array(filled, bool)


def _columns(overlaps):
    n = len(overlaps)

    def col(attr, dtype):
        return np.fromiter((getattr(o, attr) for o in overlaps), dtype, n)
    return {"read_id": col("read_id", np.int32),
            "entry_id": col("entry_id", np.int64),
            "rel_pos": col("rel_pos", np.int64),
            "rc": col("rc", np.uint8),
            "ref_begin": col("ref_begin", np.int64),
            "query_begin": col("query_begin", np.int32),
            "query_end": col("query_end", np.int32)}


def _fetch(tensors: dict) -> dict:
    """The tensors on the host: one copy each into pinned memory on the
    current stream, then a wait on an event recorded after them."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        return {k: v.numpy() for k, v in tensors.items()}
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in tensors.items()}
    for k, v in tensors.items():
        host[k].copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return {k: v.numpy() for k, v in host.items()}


def _texts(buf: np.ndarray, lens: np.ndarray) -> List[str]:
    return [bytes(buf[k, :lens[k]]).decode("latin-1")
            for k in range(len(lens))]


def operands(overlaps, filled, batch, gindex, config, device):
    """The kernels' operands for these overlaps on `device`: (tensors,
    host) with host the overlap columns, the reference windows' lengths
    and what the relaunch needs.  Stages: sam_windows (the columns and
    the reference windows gathered on the host), sam_upload."""
    dev = torch.device(device)
    with metrics.stage("sam_windows", items=len(overlaps)):
        c = _columns(overlaps)
        lengths = np.asarray(batch.lengths, np.int32)
        qlen = lengths[c["read_id"]]
        width = max(int(qlen.max()), 1)
        bases, offs = gindex.bases_concat, gindex.entry_offsets
        win, wlen, ref_start = sam_cuda.native_windows(
            bases, offs, c["entry_id"], c["rel_pos"], qlen, width)
        dwin, dlen, elen_rel = sam_cuda.diff_windows(
            bases, offs, c["entry_id"], c["ref_begin"],
            -(-(width + WINDOW_PAD) // 16) * 16)   # rows of 16 B words
    with metrics.stage("sam_upload", items=len(overlaps)):
        t = {k: _put(v, dev) for k, v in (
            ("reads", batch.bases), ("qual", batch.quality),
            ("read_len", lengths), ("read_id", c["read_id"]),
            ("rc", c["rc"]), ("win", win), ("wlen", wlen),
            ("ref_start", ref_start), ("filled", filled),
            ("qb", c["query_begin"]), ("qe", c["query_end"]),
            ("dwin", dwin), ("dlen", dlen))}
    host = dict(c, lengths=lengths, wlen=wlen, ref_start=ref_start,
                dlen=dlen, elen_rel=elen_rel, bases=bases, offs=offs)
    return t, host


def _put(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a)).to(dev)


def cigar_args(t, host, config):
    """sam_cuda.sam_cigar's arguments from operands()."""
    p = config.sw
    return (t["reads"], t["read_len"], t["read_id"], t["rc"], t["win"],
            t["wlen"], t["ref_start"],
            (p.match, p.mismatch, p.gap_open, p.gap_extend),
            config.score_threshold, sam_cuda.native_max_ops(host["lengths"]))


def diff_args(t, cig):
    """sam_cuda.sam_diff's arguments from operands() and sam_cigar's
    columns: a cigar only for the pairs _fill_cigars fills, None
    elsewhere."""
    cigar_len = torch.where(t["filled"], cig["cigar_len"],
                            sam_cuda.NO_CIGAR).to(torch.int32)
    return (t["reads"], t["qual"], t["read_len"], t["read_len"],
            t["read_id"], t["rc"], t["qb"], t["qe"], cig["cigar_buf"],
            cigar_len, t["dwin"], t["dlen"],
            *sam_cuda.quality_tables(t["reads"].device))


def overlap_diffs(overlaps, filled, batch, gindex, config, device):
    """(cigar, md, nm, prob) lists, one entry an overlap: what
    SAMEntry.init_from_overlap takes from get_cigar_and_md after
    _fill_cigars, computed by the two kernels (their plain versions on
    the CPU).  Stages: those of operands(), sam_kernels (both kernels and
    the fetch), sam_relaunch (the rows whose texts or window were too
    short), sam_texts (the texts, NM and prob as Python objects)."""
    n = len(overlaps)
    if n == 0:
        return [], [], [], []
    dev = torch.device(device)
    t, host = operands(overlaps, filled, batch, gindex, config, dev)
    with metrics.stage("sam_kernels", items=n):
        cig = sam_cuda.sam_cigar(*cigar_args(t, host, config))
        dargs = diff_args(t, cig)
        out = _fetch(sam_cuda.sam_diff(*dargs))
    cap = sam_cuda.TEXT_CAP
    dlen = host["dlen"]
    short = (out["cigar_n"] > cap) | (out["md_n"] > cap) | \
        ((out["ref_need"] > dlen) & (host["elen_rel"] > dlen))
    rows, again = np.flatnonzero(short), None
    if rows.size:
        with metrics.stage("sam_relaunch", items=rows.size):
            t_rows = _put(rows, dev)
            wide = int(max(out["ref_need"][rows].max(), dlen[rows].max()))
            dwin2, dlen2, _ = sam_cuda.diff_windows(
                host["bases"], host["offs"], host["entry_id"][rows],
                host["ref_begin"][rows], wide)
            picked = [a[t_rows].contiguous() for a in dargs[4:10]]
            again = _fetch(sam_cuda.sam_diff(
                *dargs[:4], *picked, _put(dwin2, dev), _put(dlen2, dev),
                *dargs[12:], max(int(out["cigar_n"][rows].max()), 1),
                max(int(out["md_n"][rows].max()), 1)))
    with metrics.stage("sam_texts", items=n):
        cigars = _texts(out["cigar_txt"], np.minimum(out["cigar_n"], cap))
        mds = _texts(out["md_txt"], np.minimum(out["md_n"], cap))
        nms = out["nm"].tolist()
        lps = out["lp"].tolist()
        if again is not None:
            for k, cg, md, nm, lp in zip(
                    rows.tolist(), _texts(again["cigar_txt"],
                                          again["cigar_n"]),
                    _texts(again["md_txt"], again["md_n"]),
                    again["nm"].tolist(), again["lp"].tolist()):
                cigars[k], mds[k], nms[k], lps[k] = cg, md, nm, lp
        probs = [10.0 ** lp for lp in lps]
    return cigars, mds, nms, probs


def _entry(e: SAMEntry, o, k: int, diffs, index) -> None:
    """SAMEntry.init_from_overlap with the overlap's fetched diff."""
    entry = index.entries[o.entry_id]
    e.cigar = diffs[0][k]
    e.md = diffs[1][k]
    e.nm = diffs[2][k]
    e.prob = diffs[3][k]
    e.rname = entry.locus_tag
    e.pos = o.ref_begin + 1
    e.align_score = o.score


def _pair_entries(pair, at: dict, diffs, index, config):
    """sam_from_pair (SAM.h:352-433) on the fetched diffs."""
    entry = index.entries[pair.entry_id]
    r1 = SAMEntry()
    r2 = SAMEntry()
    r1.first = True
    gene = entry.get_gene(pair.ref_start, pair.ref_end)
    if gene is not None:
        r1.xg = r2.xg = gene.gene_name
        r1.xp = r2.xp = gene.protein_id
        r1.xr = r2.xr = gene.product
    r1.xt = r2.xt = entry.taxonomy_id
    conventional = True
    both = pair.has_r1 and pair.has_r2
    if config.paired_data:
        r1.multiple_segments = r2.multiple_segments = True
    if both:
        r1.all_segments_aligned = r2.all_segments_aligned = True
        conventional = pair.r1.ref_begin < pair.r2.ref_begin
        if pair.r1.rc:
            r1.rev_comp = True
            r2.next_rev_comp = True
        if pair.r2.rc:
            r2.rev_comp = True
            r1.next_rev_comp = True
    elif pair.has_r1:
        r1.next_unmapped = True
        r2.this_unmapped = True
        if pair.r1.rc:
            r1.rev_comp = True
    elif pair.has_r2:
        r2.next_unmapped = True
        r1.this_unmapped = True
        if pair.r2.rc:
            r2.rev_comp = True
    if pair.has_r1:
        _entry(r1, pair.r1, at[id(pair.r1)], diffs, index)
    if pair.has_r2:
        _entry(r2, pair.r2, at[id(pair.r2)], diffs, index)
    r1.pnext = r2.pos
    r2.pnext = r1.pos
    if not pair.has_r1:
        r1.rname = r2.rname
        r1.pos = r2.pos
        r2.pnext = r2.pos
        r1.pnext = r2.pos
    if not pair.has_r2:
        r2.rname = r1.rname
        r2.pos = r1.pos
        r1.pnext = r1.pos
        r2.pnext = r1.pos
    if not config.paired_data:
        r1.rnext = "*"
        r1.pnext = 0
        r1.next_unmapped = False
    tlen = pair.ref_end - pair.ref_start + 1
    if not (pair.has_r1 or pair.has_r2):
        tlen = 0
    if not conventional:
        tlen = -tlen
    r1.tlen = tlen
    r2.tlen = -tlen
    r1.xs = r2.xs = pair.combined_score & 0xFFFF   # SAM.h:269, uint16_t
    return r1, r2


def _read_lines(read, top, at, diffs, batch, index, config, lines) -> None:
    """writeSAMOutputPairs (SAM.h:443-512) of one read's written pairs."""
    sam_pairs = [_pair_entries(pair, at, diffs, index, config)
                 for pair in top]
    r1_hits = sum(pair.has_r1 for pair in top)
    r2_hits = sum(pair.has_r2 for pair in top)
    r1_name = batch.names[read.r1_pos]
    r2_name = batch.names[read.r2_pos] if config.paired_data else r1_name
    r1_sum = r2_sum = 0.0
    for r1, r2 in sam_pairs:
        r1.qname = r1_name
        r2.qname = r2_name
        r1_sum += r1.prob
        r2_sum += r2.prob
        r1.xo = r1_hits
        r2.xo = r2_hits
    sam_pairs[0][0].secondary = False
    sam_pairs[0][1].secondary = False
    for r1, r2 in sam_pairs:
        # sumProb == 0: the reference's NaN MAPQ prints 0 (io/sam.py)
        t1 = max(1.0 - (r1.prob / r1_sum if r1_sum else 0.0), 0.00001)
        t2 = max(1.0 - (r2.prob / r2_sum if r2_sum else 0.0), 0.00001)
        r1.mapq = math.ceil(-10.0 * math.log10(t1))
        r2.mapq = math.ceil(-10.0 * math.log10(t2))
        lines.append(r1.line(config) + "\n")
        if config.paired_data:
            lines.append(r2.line(config) + "\n")
        if config.sam_xa:
            break


def write_sam(out, reads_and_pairs, batch, gindex, config, device) -> None:
    """The SAM lines of a chunk's reads (what _fill_cigars and then
    write_sam_pairs for each read write), the diffs from the kernels on
    `device`.  Stages: sam_collect, sam_diffs (split by overlap_diffs),
    sam_lines."""
    with metrics.stage("sam_collect"):
        written, overlaps, filled = collect(reads_and_pairs, config)
    dev = torch.device(device)
    with metrics.stage("sam_diffs", items=len(overlaps)):
        if dev.type == "cuda" and overlaps:
            with torch.cuda.stream(_side_stream(dev)):
                diffs = overlap_diffs(overlaps, filled, batch, gindex,
                                      config, dev)
        else:
            diffs = overlap_diffs(overlaps, filled, batch, gindex, config,
                                  dev)
    with metrics.stage("sam_lines"):
        at = {id(o): k for k, o in enumerate(overlaps)}
        lines: List[str] = []
        for read, top in zip(reads_and_pairs, written):
            if top:
                _read_lines(read, top, at, diffs, batch, gindex, config,
                            lines)
        out.write("".join(lines))
