"""Device pair screens + pseudo-assembly chain labels
(PairedOverlap.h:361-436, 471-576).

Counterpart of kslam_tpu/ops/screens_dev.py: segmented-scan formulations
of the reference's per-read / per-entry loops over columnar pair sets
(group id = read-pair position):

  * score screen: stable score-descending order per group, keep
    combinedScore >= fraction * (per-group top) under C++ double rounding,
  * insert screen (replace=True): per group, stable sort by insertSize
    ascending; oversize FULL pairs mutate into R2-only halves in place and
    append an R1 half-pair at the group tail (PairedOverlap.h:416-430),
  * pseudo-assembly chains: per entry over ref_start-sorted pairs, chains
    break where ref_start > runningMax(ref_end) - 20; chains of length > 1
    rescore every member coverage * avgScorePerBase * length, exactly on
    the host in the CLI pipeline (pipeline/device_path.rescore_chains) or
    in float32 on the device (pseudo_assembly_device).

Columns that are uint32 in the reference package (combined_score bits,
insert_size) are int64 here: combined_score holds the int32 bit pattern
(sign-extended), insert_size the uint32 value.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .lca import segment_reduce
from .rows import lex_perm, shift1

NONE = -1
INT64_MAX = 2**63 - 1
U32_MASK = 0xFFFFFFFF


class PairCols(NamedTuple):
    """Columnar pair state threaded through the screens."""
    group: torch.Tensor           # int32 [P] read-pair position
    r1_idx: torch.Tensor          # int32 [P] overlap row (-1 = absent)
    r2_idx: torch.Tensor          # int32 [P]
    combined_score: torch.Tensor  # int64 [P] (int32 values, uint32 bits)
    entry_id: torch.Tensor        # int32 [P]
    ref_start: torch.Tensor       # int32 [P]
    ref_end: torch.Tensor         # int32 [P]
    insert_size: torch.Tensor     # int64 [P] (uint32 values)
    valid: torch.Tensor           # bool [P]


def _sort_perm(valid, key_hi, key_lo):
    """Stable permutation ordering by (valid desc, key_hi, key_lo);
    key_hi/key_lo are int64 holding uint32 values."""
    return lex_perm(torch.where(valid, key_hi.to(torch.int64), INT64_MAX),
                    key_lo.to(torch.int64))


def _permute(cols: PairCols, perm) -> PairCols:
    return PairCols(*(c[perm] for c in cols))


def _segment_first_broadcast(first, value_i64):
    """Broadcast each segment's first-row value (int64, >= 0, < 2^33-1)
    to the whole segment (segments = runs delimited by `first`)."""
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    code = seg * (2**33) + torch.where(first, value_i64 + 1, 0)
    scan = torch.cummax(code, 0).values
    return scan - seg * (2**33) - 1


def _fraction_mantissa(fraction: float):
    """Static (M, S) with fraction == M * 2**-S exactly and
    M in [2^52, 2^53) (the double's normalized mantissa)."""
    num, den = float(fraction).as_integer_ratio()
    s = den.bit_length() - 1
    m = num
    while m < 2**52:
        m <<= 1
        s += 1
    while m >= 2**53:
        m >>= 1
        s -= 1
    return m, s


def _bitlen_u32(x):
    """Bit length of int64 values in [1, 2^32)."""
    bl = torch.zeros_like(x)
    for k in (16, 8, 4, 2, 1):
        c = x >= (1 << k)
        bl = bl + torch.where(c, k, 0)
        x = torch.where(c, x >> k, x)
    return bl + 1


def exact_score_threshold(top, fraction: float):
    """Smallest uint32 score that survives `score >= top * fraction` under
    the reference's C++ double semantics (PairedOverlap.h:376-380): both
    uint32 -> double conversions are exact, the product rounds ONCE to
    double (round-half-even), and an integer score passes iff
    score >= ceil(product).  The product's 85-bit integer numerator is
    computed in two int64 limbs and rounded to the 53-bit double mantissa
    exactly (the reference package's formulation, kept as it is).

    top: int64 [N] (uint32 values).  Returns int64 [N] thresholds."""
    if not (fraction > 0):
        return torch.zeros_like(top)
    m_full, s_exp = _fraction_mantissa(fraction)
    mhi, mlo = m_full >> 27, m_full & (2**27 - 1)
    t = top
    one = torch.ones_like(t)
    a = t * mhi                              # < 2^58
    b = t * mlo                              # < 2^59
    hi = a + (b >> 27)                       # P = hi*2^27 + lo, lo < 2^27
    lo = b & (2**27 - 1)
    bl = _bitlen_u32(torch.clamp(t, min=1))
    # P has bl+52 or bl+53 significant bits (M is normalized)
    carry = (hi >= (one << (bl + 25))).to(torch.int64)
    sh = bl - 1 + carry                      # drop sh bits: 53 remain
    sh_lo = torch.clamp(sh, max=27)
    sh_hi = torch.clamp(sh - 27, min=0)
    q = torch.where(sh <= 27,
                    (hi << (27 - sh_lo)) | (lo >> sh_lo),
                    hi >> sh_hi)
    r = torch.where(sh <= 27,
                    lo & ((one << sh_lo) - 1),
                    ((hi & ((one << sh_hi) - 1)) << 27) | lo)
    half = torch.where(sh > 0, one << torch.clamp(sh - 1, min=0), 0)
    q = q + torch.where(r > half, 1,
                        torch.where((r == half) & (sh > 0), q & 1, 0))
    # threshold = ceil(q * 2^(sh - S)); q < 2^54
    d = s_exp - sh
    d_c = torch.clamp(d, 0, 54)
    t_div = (q + (one << d_c) - 1) >> d_c
    neg = torch.clamp(-d, 0, 33)
    big = 1 << 33                            # > any uint32 score
    sat = (-d > 33) | (q > ((one << 62) >> neg))
    t_mul = torch.where(sat, big, q << neg)
    thr = torch.where(d >= 0, t_div, t_mul)
    return torch.where(t <= 0, 0, thr)


def screen_by_score_device(cols: PairCols, fraction: float) -> PairCols:
    """screenPairedAlignmentsByScore (PairedOverlap.h:361-390)."""
    score_u = cols.combined_score & U32_MASK
    perm = _sort_perm(cols.valid, cols.group, U32_MASK - score_u)
    out = _permute(cols, perm)
    first = shift1(out.group, -1) != out.group
    out_u = out.combined_score & U32_MASK
    top = _segment_first_broadcast(first, out_u)
    thr = exact_score_threshold(top, fraction)
    return out._replace(valid=out.valid & (out_u >= thr))


def screen_by_insert_device(cols: PairCols, max_insert,
                            ov_score, ov_begin, ov_end) -> PairCols:
    """screenPairedAlignmentsByInsertSize with replace=true
    (PairedOverlap.h:396-436), the only mode the pipeline runs.

    ov_score/begin/end: per-overlap columns indexed by r1_idx/r2_idx.
    The output has 2x rows (appended R1 halves)."""
    perm = _sort_perm(cols.valid, cols.group, cols.insert_size)
    out = _permute(cols, perm)
    over = out.valid & (out.insert_size > int(max_insert))
    r2 = torch.clamp(out.r2_idx.to(torch.int64), min=0)
    r1 = torch.clamp(out.r1_idx.to(torch.int64), min=0)
    mutated = out._replace(
        r1_idx=torch.where(over, NONE, out.r1_idx),
        combined_score=torch.where(over, ov_score[r2].to(torch.int64),
                                   out.combined_score),
        ref_start=torch.where(over, ov_begin[r2], out.ref_start),
        ref_end=torch.where(over, ov_end[r2], out.ref_end),
        insert_size=torch.where(over, 0, out.insert_size))
    app = out._replace(
        r2_idx=torch.full_like(out.r2_idx, NONE),
        combined_score=ov_score[r1].to(torch.int64), ref_start=ov_begin[r1],
        ref_end=ov_end[r1], insert_size=torch.zeros_like(out.insert_size),
        valid=over & (out.r1_idx != NONE))
    both = PairCols(*(torch.cat([a, b]) for a, b in zip(mutated, app)))
    p = out.group.shape[0]
    dev = out.group.device
    order = torch.arange(p, dtype=torch.int64, device=dev)
    lo_key = torch.cat([order, order | (1 << 31)])
    perm2 = _sort_perm(both.valid, both.group, lo_key)
    return _permute(both, perm2)


def pseudo_assembly_chains(cols: PairCols):
    """Device half of pseudoAssembly: entry-sort + chain labeling.
    Returns (perm, cseg): the stable entity/ref_start sort permutation and
    per-sorted-row chain ids (rescoring runs on the host with exact
    C++-double semantics, pipeline/device_path.rescore_sorted_host)."""
    perm = _sort_perm(cols.valid, cols.entry_id,
                      cols.ref_start.to(torch.int64) + 2**31)
    out = _permute(cols, perm)
    first_e = (shift1(out.entry_id, -1) != out.entry_id) | \
        (shift1(out.valid, True) != out.valid)
    if len(first_e):
        first_e[0] = True
    eseg = torch.cumsum(first_e.to(torch.int64), 0) - 1
    code = eseg * (2**33) + (out.ref_end.to(torch.int64) + 2**31)
    scan = torch.cummax(code, 0).values
    shifted = shift1(scan, -2**62)
    same = shift1(eseg, -1) == eseg
    prevmax = torch.where(same, shifted - eseg * (2**33) - 2**31, -1000000)
    brk = (out.ref_start.to(torch.int64) > prevmax - 20) | first_e
    cseg = torch.cumsum(brk.to(torch.int64), 0) - 1
    return perm, cseg


def _chain_extents(cseg):
    """(first row, length) of each chain, in chain id order, of rows
    sorted by chain (cseg: chain ids 0, 1, ... in row order)."""
    n = cseg.shape[0]
    first = torch.ones(n, dtype=torch.bool, device=cseg.device)
    first[1:] = cseg[1:] != cseg[:-1]
    starts = torch.nonzero(first).squeeze(1)
    return starts, torch.diff(starts, append=starts.new_tensor([n]))


def _chain_sums(x, starts, lens):
    """Per-chain sums of x [P, C], each chain's rows added one after the
    other in row order from 0, as XLA:CPU's scatter adds them, on any
    device: step k adds row start[c] + k to every chain c longer than k.
    Chains are visited longest first, so the chains of step k are a
    prefix.  One host sync, then one Python step (a gather and an add)
    per row of the longest chain: the cost grows with the longest chain,
    not with P, and deep coverage can make one chain a whole entry (1e5
    steps or more).  That is acceptable only while pseudo_assembly_device
    stays off the CLI path (the CLI rescores on the host); were it to
    reach the CLI, one launch of one thread per chain adding its rows in
    order would replace the loop."""
    acc = x.new_zeros((len(starts),) + x.shape[1:])
    if len(starts) == 0:
        return acc
    order = torch.argsort(lens, descending=True, stable=True)
    first = starts[order]
    lens_host = lens[order].cpu().numpy()
    # the number of chains longer than k, for every step k
    live = np.searchsorted(-lens_host, -np.arange(int(lens_host[0])),
                           side="left")
    for k, m in enumerate(live.tolist()):
        acc[:m] += x[first[:m] + k]
    out = torch.empty_like(acc)
    out[order] = acc
    return out


def pseudo_assembly_device(cols: PairCols) -> PairCols:
    """pseudoAssembly (PairedOverlap.h:471-576) with float32 rescoring on
    the device: rescores in place, input order preserved (the reference
    package's dry-run and probe path; the CLI pipeline rescores exactly on
    the host).

    Every step repeats the reference package's float32 arithmetic: IEEE
    0/0 -> nan and x/0 -> inf, non-finite scores -> 0, trunc -> int64
    (saturating, as XLA's convert does) -> & 0xFFFFFFFF -> int32.  The
    per-chain float32 sums add rows in chain order, as XLA:CPU's scatter
    does (_chain_sums), so the result is the reference package's exactly
    on the CPU and on a card alike.  A chain never mixes valid and
    invalid rows (pseudo_assembly_chains breaks chains where `valid`
    changes), so a chain's valid count is its length or 0."""
    perm, cseg = pseudo_assembly_chains(cols)
    out = _permute(cols, perm)
    valid = out.valid
    starts, lens = _chain_extents(cseg)
    n_chains = len(starts)
    span = torch.abs(out.ref_end - out.ref_start).to(torch.float32)
    score_f = (out.combined_score & U32_MASK).to(torch.float32)
    pb = torch.where(span != 0, score_f / span, torch.inf)

    sums = _chain_sums(torch.stack([torch.where(valid, span, 0.0),
                                    torch.where(valid, pb, 0.0)], 1),
                       starts, lens)
    nb, pbs = sums[:, 0], sums[:, 1]
    cnt = torch.where(valid[starts], lens, 0)
    hi = segment_reduce(torch.where(valid, out.ref_end, -2**31)
                        .to(torch.int64), cseg, n_chains, "amax", -2**31)
    start0 = segment_reduce(torch.where(valid, out.ref_start, 2**31 - 1)
                            .to(torch.int64), cseg, n_chains, "amin",
                            2**31 - 1)

    length = (hi - start0).to(torch.float32)
    cov = nb / length                    # 0/0 -> nan, x/0 -> inf (IEEE)
    avg = pbs / cnt.to(torch.float32)
    new_score_f = cov * avg * length
    tr = torch.where(torch.isfinite(new_score_f), new_score_f, 0.0)
    # float -> int64 saturates like XLA's convert; torch on the CPU would
    # wrap scores >= 2^63 to int64 min
    i64 = torch.where(tr >= 2.0**63, INT64_MAX,
                      torch.trunc(tr).to(torch.int64))
    new_score = (i64 & U32_MASK).to(torch.int32).to(torch.int64)
    rescored = (cnt[cseg] > 1) & valid
    score_sorted = torch.where(rescored, new_score[cseg], out.combined_score)
    # scatter scores back to the input order
    score_final = torch.empty_like(score_sorted).index_put_((perm,),
                                                            score_sorted)
    return cols._replace(combined_score=score_final)
