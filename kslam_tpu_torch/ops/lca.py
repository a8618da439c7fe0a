"""Vectorized LCA over the NCBI taxonomy (device).

Counterpart of kslam_tpu/ops/lca.py: binary lifting over dense int32
tables (up[j][v] is the 2^j-th ancestor; roots lift to themselves after
the reference's parent==1 root cut) plus a DFS preorder numbering, so the
LCA of a node set is the LCA of its two preorder extremes.

Set semantics mirrored exactly (db/taxonomy.lowest_common_ancestor):
  * taxid 0 anywhere -> 0 (its root path is empty),
  * two equal taxids agree even when absent from the taxonomy,
  * an unknown taxid against any different taxid -> 0,
  * nodes under different post-cut roots -> 0.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NONE = -1


class LcaTables(NamedTuple):
    taxids: torch.Tensor    # int64 [V] sorted (int32 values)
    up: torch.Tensor        # int64 [J, V] 2^j-th ancestors (self at roots)
    depth: torch.Tensor     # int64 [V]
    preorder: torch.Tensor  # int64 [V] global DFS preorder number


def build_device_tables(taxdb, device) -> LcaTables:
    """Dense lifting tables + DFS preorder from a TaxonomyDB (host
    precompute), as tensors on `device`."""
    taxids, parent_idx, depth = taxdb.build_tables()
    v = len(taxids)
    dev = torch.device(device)
    if v == 0:
        z = torch.zeros(0, dtype=torch.int64, device=dev)
        return LcaTables(z, torch.zeros((1, 0), dtype=torch.int64,
                                        device=dev), z, z)
    max_depth = int(depth.max())
    j_levels = max(1, int(np.ceil(np.log2(max_depth + 1))) + 1)
    up = np.zeros((j_levels, v), np.int32)
    self_idx = np.arange(v, dtype=np.int32)
    up[0] = np.where(parent_idx < 0, self_idx, parent_idx)
    for j in range(1, j_levels):
        up[j] = up[j - 1][up[j - 1]]
    order = np.lexsort(tuple(
        _ancestor_at_depth(up, depth, d) for d in range(max_depth, -1, -1)))
    preorder = np.empty(v, np.int32)
    preorder[order] = np.arange(v, dtype=np.int32)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    return LcaTables(t(taxids.astype(np.int32)), t(up), t(depth),
                     t(preorder))


def _ancestor_at_depth(up: np.ndarray, depth: np.ndarray,
                       d: int) -> np.ndarray:
    """Host: ancestor of every node at depth d (self when depth < d)."""
    v = up.shape[1]
    node = np.arange(v, dtype=np.int32)
    delta = np.maximum(depth - d, 0)
    for j in range(up.shape[0] - 1, -1, -1):
        take = (delta & (1 << j)) != 0
        node = np.where(take, up[j][node], node)
    return node


def node_of_taxid(taxid, tables: LcaTables):
    """taxid [M] -> dense node index (int64), NONE when unknown."""
    v = tables.taxids.shape[0]
    taxid = taxid.to(torch.int64)
    if v == 0:
        return torch.full(taxid.shape, NONE, dtype=torch.int64,
                          device=taxid.device)
    i = torch.clamp(torch.searchsorted(tables.taxids, taxid), 0, v - 1)
    return torch.where(tables.taxids[i] == taxid, i, NONE)


def _lift_to_depth(node, target_depth, tables: LcaTables):
    d = tables.depth[torch.clamp(node, min=0)]
    delta = torch.clamp(d - target_depth, min=0)
    for j in range(tables.up.shape[0] - 1, -1, -1):
        take = (delta & (1 << j)) != 0
        node = torch.where(take, tables.up[j][torch.clamp(node, min=0)],
                           node)
    return node


def _lca_nodes(a, b, tables: LcaTables):
    """Pairwise LCA of dense node indices (both must be >= 0); NONE when
    the nodes live under different post-cut roots."""
    da = tables.depth[torch.clamp(a, min=0)]
    db = tables.depth[torch.clamp(b, min=0)]
    target = torch.minimum(da, db)
    a2 = _lift_to_depth(a, target, tables)
    b2 = _lift_to_depth(b, target, tables)
    equal_now = a2 == b2
    x, y = a2, b2
    for j in range(tables.up.shape[0] - 1, -1, -1):
        ux = tables.up[j][torch.clamp(x, min=0)]
        uy = tables.up[j][torch.clamp(y, min=0)]
        step = ux != uy
        x = torch.where(step, ux, x)
        y = torch.where(step, uy, y)
    parent = tables.up[0][torch.clamp(x, min=0)]
    same_root = parent == tables.up[0][torch.clamp(y, min=0)]
    cand = torch.where(same_root & (x != y), parent, NONE)
    return torch.where(equal_now, a2, cand)


def segment_reduce(values, seg_id, num_segments: int, reduce: str,
                   empty: int):
    """Per-segment max/min of int64 `values`; `empty` for segments with no
    rows."""
    out = torch.full((num_segments,), empty, dtype=torch.int64,
                     device=values.device)
    return out.scatter_reduce(0, seg_id.to(torch.int64), values, reduce,
                              include_self=False)


def lca_segments_reduce(taxids, seg_id, valid, tables: LcaTables,
                        num_segments: int):
    """Per-segment set-LCA via the preorder-extreme reduction: segment
    reductions of (preorder, node) codes + ONE pairwise tree-LCA.

    Returns int64 [num_segments] per-segment LCAs (0 for segments with no
    valid rows, matching the empty-set contract)."""
    taxids = taxids.to(torch.int64)
    tax = torch.where(valid, taxids, NONE)
    node = node_of_taxid(tax, tables)
    known = valid & (tax != 0) & (node != NONE)
    is_zero = valid & (tax == 0)
    is_unknown = valid & (tax != 0) & (node == NONE)
    i64min, i64max = -2**63, 2**63 - 1

    def smax(x):
        return segment_reduce(x.to(torch.int64), seg_id, num_segments,
                              "amax", i64min)

    def smin(x):
        return segment_reduce(x.to(torch.int64), seg_id, num_segments,
                              "amin", i64max)

    seg_any_zero = smax(is_zero) > 0
    seg_any_unknown = smax(is_unknown) > 0
    tmax = smax(torch.where(valid, tax, -1))
    tmin = smin(torch.where(valid, tax, 2**31 - 1))
    any_valid = smax(valid) > 0
    all_same = any_valid & (tmax == tmin)

    if tables.taxids.shape[0] == 0:
        return torch.where(all_same, tmax, 0)

    pre = tables.preorder[torch.clamp(node, min=0)]
    code = (pre << 32) | torch.clamp(node, min=0)
    cmin = smin(torch.where(known, code, 2**62))
    cmax = smax(torch.where(known, code, -1))
    node_min = cmin & 0xFFFFFFFF
    node_max = cmax & 0xFFFFFFFF
    has_known = cmax >= 0
    n = _lca_nodes(torch.where(has_known, node_min, 0),
                   torch.where(has_known, node_max, 0), tables)
    tree_tax = torch.where(n == NONE, 0,
                           tables.taxids[torch.clamp(n, min=0)])
    out = torch.where(all_same, tmax,
                      torch.where(seg_any_zero | seg_any_unknown, 0,
                                  tree_tax))
    return torch.where(any_valid, out, 0)
