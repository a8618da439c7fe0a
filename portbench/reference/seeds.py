"""Seeding: canonical read k-mers, the exact join against the sorted
index keys, pair expansion, the overlap sort and the chained dedup.

Frozen copy of kslam_tpu_torch's ops/kmers.read_kmers_from_codes,
ops/match (expand_seeds, finish_overlaps, chained_dedup_device,
compact_overlaps) and ops/rows, with the join fixed to the exact search
(ops/join.searchsorted_both) and no capacity or fanout caps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

K = 32
FLIP = -(1 << 63)
INT32_MAX = 2**31 - 1
INT64_MAX = 2**63 - 1


def lex_perm(*keys):
    """Stable permutation ordering rows by `keys`, most significant
    first."""
    perm = torch.sort(keys[-1], stable=True).indices
    for k in reversed(keys[:-1]):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def shift1(x, fill):
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def read_kmers(kcodes, lengths):
    """(key int64 [N, W], offset int32, rc bool, valid bool) of every
    position of the padded reads' 2-bit codes [N, L]."""
    codes = kcodes.to(torch.int64)
    n, l = codes.shape
    w = l - K + 1
    fwd = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
    rev = torch.zeros((n, w), dtype=torch.int64, device=codes.device)
    rc_codes = codes ^ 2
    for t in range(K):
        fwd = (fwd << 2) | codes[:, t:t + w]
        rev = rev | (rc_codes[:, t:t + w] << (2 * t))
    fwd = fwd ^ FLIP
    rev = rev ^ FLIP
    start = torch.arange(w, dtype=torch.int32, device=codes.device)[None, :]
    lengths = lengths.to(torch.int32)[:, None]
    valid = (start + K) <= lengths
    rc = fwd >= rev
    key = torch.where(rc, rev, fwd)
    offset = torch.where(rc, lengths - start - K, start).to(torch.int32)
    return key, offset, rc, valid


class Overlaps(NamedTuple):
    read_id: torch.Tensor
    entry_id: torch.Tensor
    rel_pos: torch.Tensor
    rc: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def expand(key, off, rc, valid, lengths, index_keys, index_pack,
           drop_escaped=None):
    """Every (read k-mer, index slot) pair of equal keys, packed into the
    overlap sort words (key1, key2).  drop_escaped: a bool mask over the
    queries whose matches are dropped (the control's inexact join)."""
    n, w = key.shape
    dev = key.device
    q = key.reshape(-1)
    q_off = off.reshape(-1).to(torch.int64)
    q_rc = rc.reshape(-1)
    q_read = torch.arange(n, dtype=torch.int64, device=dev) \
        .repeat_interleave(w)
    q_ok = valid.reshape(-1) & (q != FLIP)
    lo = torch.searchsorted(index_keys, q, right=False)
    hi = torch.searchsorted(index_keys, q, right=True)
    cnt = torch.where(q_ok, hi - lo, 0)
    if drop_escaped is not None:
        cnt = torch.where(drop_escaped.reshape(-1), 0, cnt)
    q_lens = lengths.to(torch.int64)[:, None].expand(n, w).reshape(-1)
    off_rcspace = torch.clamp(q_lens - q_off - K, min=0)
    starts = torch.cumsum(cnt, 0) - cnt
    total = int(cnt.sum())
    p = torch.arange(max(total, 1), dtype=torch.int64, device=dev)
    qi = torch.clamp(torch.searchsorted(starts, p, right=True) - 1, 0,
                     len(q) - 1)
    in_range = p < total
    slot = torch.clamp(lo[qi] + (p - starts[qi]), 0, len(index_pack) - 1)
    ip = index_pack[slot]
    e_id = ((ip >> 33) & 0x7FFFFFFF).to(torch.int32)
    gb_off = ((ip >> 1) & 0xFFFFFFFF).to(torch.int32)
    gb_rc = (ip & 1).to(torch.bool)
    r_id = q_read[qi].to(torch.int32)
    r_off = q_off[qi].to(torch.int32)
    r_off_rc = off_rcspace[qi].to(torch.int32)
    r_rc = q_rc[qi]
    offset = torch.where(gb_rc, r_off_rc, r_off)
    rel = (gb_off - offset).to(torch.int32)
    orc = gb_rc != r_rc
    key1 = (r_id.to(torch.int64) << 32) | e_id.to(torch.int64)
    key1 = torch.where(in_range, key1, INT64_MAX)
    key2 = ((rel.to(torch.int64) + 2**31) << 1) | orc.to(torch.int64)
    return key1, key2


def chained_dedup(read_id, entry_id, rel, valid):
    """Exact chained |delta rel| < 3 dedup (Overlap.h:79-85) on rows
    sorted by (read, entry, rel): keep mask and count."""
    n = rel.shape[0]
    dev = rel.device
    prev_rel = shift1(rel, INT32_MAX)
    same_group = (read_id == shift1(read_id, INT32_MAX)) & \
        (entry_id == shift1(entry_id, INT32_MAX))
    dup = same_group & (rel == prev_rel) & valid
    distinct = valid & ~dup
    is_head = distinct & (~same_group | (rel.to(torch.int64) -
                                         prev_rel.to(torch.int64) >= 3))
    gid = torch.cumsum((~same_group).to(torch.int64), 0)
    key = (gid << 33) + rel.to(torch.int64) + 2**31
    succ = torch.searchsorted(key, key + 3, right=False)
    s_ok = (succ < n) & (gid[torch.clamp(succ, max=n - 1)] == gid)
    succ = torch.where(s_ok & distinct, succ, n)
    reach = torch.cat([is_head, torch.zeros(1, dtype=torch.bool,
                                            device=dev)])
    nxt = torch.cat([succ, torch.full((1,), n, dtype=succ.dtype,
                                      device=dev)])
    for _ in range(max(1, (n - 1).bit_length())):
        tgt = torch.where(reach[:n], nxt[:n], n)
        reach = reach.index_fill(0, tgt, True)
        nxt = nxt[nxt]
    keep = reach[:n] & distinct
    return keep, keep.sum().to(torch.int32)


def overlaps(key1, key2) -> Overlaps:
    """Sort, dedup and compact the expanded pairs: the candidates, sorted
    by (read, entry, relPos, rc)."""
    perm = lex_perm(key1, key2)
    key1, key2 = key1[perm], key2[perm]
    in_range = key1 != INT64_MAX
    r_id = torch.where(in_range, (key1 >> 32).to(torch.int32), INT32_MAX)
    e_id = torch.where(in_range, (key1 & 0xFFFFFFFF).to(torch.int32),
                       INT32_MAX)
    rel = torch.where(in_range, ((key2 >> 1) - 2**31).to(torch.int32),
                      INT32_MAX)
    rc = (key2 & 1).to(torch.bool)
    keep, count = chained_dedup(r_id, e_id, rel, in_range)
    sel = torch.argsort((~keep).to(torch.int8), stable=True)[:int(count)]
    return Overlaps(r_id[sel], e_id[sel], rel[sel], rc[sel], keep[sel],
                    count)
