"""One chunk of read pairs classified by the plain reference: the taxid of
each pair with hits, as the port's _PerRead gives it.

The chunk runs as one batch: read pairs never span the port's device
batches, the insert model sorts the chunk's insert sizes, and the
pseudo-assembly and the screens after it are chunk-wide in the port too.
Seeding and SW run as whole-tensor torch operations on the device
(seeds.py, sw.py); pairing, the screens and the pseudo-assembly as the
sequential host sweeps of pairs.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import pairs as P
from . import seeds, sw as swm


class PairCols(NamedTuple):
    """The pairs that survive the screens, a row each, in the order the
    pipeline keeps them (a read's pairs by falling score)."""
    group: torch.Tensor           # int64 pair index in the chunk
    r1_idx: torch.Tensor          # int64 candidate row of R1's half, -1
    r2_idx: torch.Tensor          # int64 candidate row of R2's half, -1
    combined_score: torch.Tensor  # int64 (uint32 values)


def tables(dev):
    """(k-mer codes, SW codes) lookup tables on `dev`: A=0 C=1 T=2 G=3,
    else 0 (k-mers) or 4 (SW; lowercase acgt and U/u as their base)."""
    kl = torch.zeros(256, dtype=torch.uint8, device=dev)
    sl = torch.full((256,), 4, dtype=torch.uint8, device=dev)
    for chars, v in ((b"A", 0), (b"C", 1), (b"T", 2), (b"G", 3)):
        kl[chars[0]] = v
    for chars, v in ((b"Aa", 0), (b"Cc", 1), (b"Tt", 2), (b"Gg", 3),
                     (b"Uu", 0)):
        for c in chars:
            sl[c] = v
    return kl, sl


def ref_db(bases_u8, offsets, kmers_u64, entry_id, offset, rc, device):
    """The reference's own columns from the generated DB: sorted int64
    keys (word ^ 2^63), the slot words entry<<33 | offset<<1 | rc, the
    flat SW codes and the entry offsets."""
    keys = torch.as_tensor(
        (np.asarray(kmers_u64, np.uint64) ^ np.uint64(1 << 63))
        .view(np.int64)).to(device)
    pack = torch.as_tensor(
        ((np.asarray(entry_id).astype(np.uint64) << np.uint64(33)) |
         (np.asarray(offset).astype(np.uint64) << np.uint64(1)) |
         np.asarray(rc).astype(np.uint64)).view(np.int64)).to(device)
    _, sl = tables(device)
    gcodes = sl[bases_u8.to(device).to(torch.int64)]
    return dict(keys=keys, pack=pack, gcodes=gcodes,
                offsets=torch.as_tensor(np.asarray(offsets, np.int64))
                .to(device))


def lca(taxids, parent_of) -> int:
    """TaxonomyDatabase.h:185-223: root paths (parent 1 cuts), common
    prefix."""
    paths = []
    for t in taxids:
        path = []
        while t != 0:
            path.append(t)
            p = parent_of.get(t)
            t = 0 if p is None or p == 1 else p
        paths.append(path[::-1])
    paths.sort(key=len)
    consensus = 0
    for i in range(len(paths[0])):
        value = 0
        for path in paths:
            if value == 0:
                value = path[i]
            elif value != path[i]:
                return consensus
        consensus = value
    return consensus


def classify(r1, r2, db: dict, entry_taxids: np.ndarray, parent_of: dict,
             params: dict, control=None, stats=None, detail=None) -> dict:
    """{pair index: taxid} of the pairs of r1, r2 (ASCII u8 [P, L] on the
    reference's device) that keep a hit.  params: sw (match, mismatch,
    gap_open, gap_extend), score_threshold (the least SW score a
    candidate keeps), fraction, pseudo_assembly, pad (the padded read
    length).  control: None, or "sw8" (SW saturating at 255).
    detail: a dict to receive the surviving pair columns in the
    pipeline's order ("cols"), the candidates ("ov") and their
    alignments ("al"), for the SAM lines."""
    dev = db["keys"].device
    n_pairs, rl = r1.shape
    pad = int(params["pad"])
    kl, sl = tables(dev)
    reads = torch.zeros((2 * n_pairs, pad), dtype=torch.uint8, device=dev)
    reads[:n_pairs, :rl] = r1.to(dev)
    reads[n_pairs:, :rl] = r2.to(dev)
    lengths = torch.full((2 * n_pairs,), rl, dtype=torch.int32, device=dev)
    ascii64 = reads.to(torch.int64)
    key, off, rc, valid = seeds.read_kmers(kl[ascii64], lengths)
    ov = seeds.overlaps(*seeds.expand(key, off, rc, valid, lengths,
                                      db["keys"], db["pack"]))
    if stats is not None:
        stats.update(queries=int(valid.sum()), candidates=int(ov.count))
    del key, off, rc, valid
    al = swm.align_candidates(
        ov.read_id, ov.entry_id, ov.rel_pos, ov.rc, sl[ascii64], lengths,
        db["gcodes"], db["offsets"], params["sw"], pad,
        saturate=255 if control == "sw8" else None)
    del ascii64
    mid = n_pairs
    keep = torch.nonzero(al.score >= int(params["score_threshold"])) \
        .reshape(-1)
    cols = [c[keep].tolist() for c in (keep, ov.read_id, ov.entry_id,
                                       ov.rel_pos, ov.rc, al.score,
                                       al.ref_begin, al.ref_end)]
    aligned = [P.Aligned(*row) for row in zip(*cols)]
    del cols
    groups = P.group_pairs_per_read(
        P.get_paired_overlaps(aligned, lengths.tolist(), mid), mid)
    del aligned
    P.screen_pairs_by_insert_size(groups, P.max_allowed_insert_size(groups))
    P.screen_pairs_by_score(groups, params["fraction"])
    if params["pseudo_assembly"]:
        P.pseudo_assembly(groups)
        P.screen_pairs_by_score(groups, params["fraction"])
    if detail is not None:
        rows = [(r.r1_pos, -1 if p.r1 is None else p.r1.row,
                 -1 if p.r2 is None else p.r2.row, p.combined_score)
                for r in groups for p in r.pairs]
        t = torch.as_tensor(np.asarray(rows, np.int64).reshape(-1, 4))
        detail.update(cols=PairCols(group=t[:, 0], r1_idx=t[:, 1],
                                    r2_idx=t[:, 2], combined_score=t[:, 3]),
                      ov=ov, al=al)
    grp = np.asarray([r.r1_pos for r in groups for _ in r.pairs], np.int64)
    ent = np.asarray([p.entry_id for r in groups for p in r.pairs],
                     np.int64)
    out = {}
    if not len(grp):
        return out
    tax = entry_taxids[ent]
    order = np.lexsort((tax, grp))
    grp, tax = grp[order], tax[order]
    starts = np.flatnonzero(np.concatenate([[True], grp[1:] != grp[:-1]]))
    ends = np.append(starts[1:], len(grp))
    for s, e in zip(starts.tolist(), ends.tolist()):
        t = tax[s:e]
        out[int(grp[s])] = int(t[0]) if t[0] == t[-1] else \
            lca(sorted(set(t.tolist())), parent_of)
    return out
