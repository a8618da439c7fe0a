"""A traffic mix's paired reads, made on the device from the seed.

One general generator reads the mix's parameters (traffic/<name>.json):

  pairs               pairs in the FASTQ pair, cycled by the window
  read_bp, insert_bp  read length; insert range (inclusive)
  substitution_rate   per base, a base drawn from ACGT
  strand_swap         share of fragments read from the reverse strand
  abundance_mu/sigma  lognormal genome abundance (CAMISIM's default)
  novel_share         share of the non-host pairs from novel strains:
                      copies of novel_strains database genomes at a
                      divergence in novel_divergence, not in the DB
  host_share, host_*  share of pairs from a host genome of host_bp bases
                      (GC segments, low-complexity tracts), not in the DB

Every seed gets the same sizes: the share counts are fixed, the genome
abundances are the lognormal's quantiles, and which genome gets which,
the novel strains and their divergences come from the mix's
structure_seed; the seed draws positions, inserts, strands, errors and
the host genome's bases.  Pairs are planted as
chip_smoke.plant_pairs plants them (R1 forward at pos, R2 the reverse
complement at pos + insert - read_bp), mates swapped for a reverse-strand
fragment.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from . import genomes as G

COMP = {ord("A"): ord("T"), ord("C"): ord("G"), ord("G"): ord("C"),
        ord("T"): ord("A")}


def _largest_remainder(total: int, weights: np.ndarray) -> np.ndarray:
    share = total * weights / weights.sum()
    base = np.floor(share).astype(np.int64)
    rest = total - int(base.sum())
    base[np.argsort(-(share - base), kind="stable")[:rest]] += 1
    return base


def lognormal_quantiles(n: int, mu: float, sigma: float) -> np.ndarray:
    nd = statistics.NormalDist(mu, sigma)
    return np.exp([nd.inv_cdf((k + 0.5) / n) for k in range(n)])


def host_genome(rng, srng, t: dict, gen, device) -> torch.Tensor:
    """host_bp bases in GC segments, then low-complexity tracts
    (homopolymers or 2-5 base microsatellites), host_lc_tracts_per_mbp
    of host_lc_bp bases: how many, how long and of what from the mix's
    structure, where from the seed."""
    n = int(t["host_bp"])
    seq = G.segmented(rng, [n], t["host_gc_segment_bp"], t["host_gc"], gen,
                      device)
    per_mbp = t["host_lc_tracts_per_mbp"]
    for _ in range(int(srng.uniform(*per_mbp) * n / 1e6)):
        m = int(srng.integers(t["host_lc_bp"][0], t["host_lc_bp"][1] + 1))
        pos = int(rng.integers(0, n - m))
        seq[pos:pos + m] = G.low_complexity(srng, m, device)
    return seq


def make_reads(db: dict, t: dict, seed: int, device):
    """(r1 u8 [P, L], r2 u8 [P, L], source kind int8 [P] (0 database, 1
    novel strain, 2 host), genome int32 [P] (the database genome, or the
    one a novel strain was copied from; -1 for host)) on `device`."""
    rng, tseed = G.seeds(seed, 2)
    srng = np.random.default_rng(t["structure_seed"])
    gen = G.device_generator(device, tseed)
    n_pairs, rl = int(t["pairs"]), int(t["read_bp"])
    n_host = int(round(n_pairs * t["host_share"]))
    n_novel = int(round((n_pairs - n_host) * t["novel_share"]))
    n_db = n_pairs - n_host - n_novel
    n_gen = len(db["genome"]) and int(db["genome"].max()) + 1
    offsets, genome_of = db["offsets"], db["genome"]

    # sources: database entries, novel strains, the host genome
    src_start = list(offsets[:-1])
    src_len = list(np.diff(offsets))
    src_genome = list(genome_of)
    bufs, at = [db["bases"]], int(offsets[-1])
    src_kind = [0] * len(src_len)
    pair_src = []           # (source ids, pair count) per genome group
    w = lognormal_quantiles(n_gen, t["abundance_mu"], t["abundance_sigma"])
    counts = _largest_remainder(n_db, w)[srng.permutation(n_gen)]
    for g in range(n_gen):
        pair_src.append((np.flatnonzero(genome_of == g), int(counts[g])))
    if n_novel:
        k = int(t["novel_strains"])
        picks = srng.choice(n_gen, k, replace=False)
        divs = srng.uniform(*t["novel_divergence"], k)
        w = lognormal_quantiles(k, t["abundance_mu"], t["abundance_sigma"])
        counts = _largest_remainder(n_novel, w)[srng.permutation(k)]
        glen = db["chrom_bp"]
        for g, d, c in zip(picks.tolist(), divs.tolist(), counts.tolist()):
            e = int(np.flatnonzero(genome_of == g)[0])
            src = db["bases"][int(offsets[e]):int(offsets[e]) + glen]
            bufs.append(G.mutated(src, [d], gen)[0])
            pair_src.append((np.asarray([len(src_len)]), c))
            src_start.append(at)
            src_len.append(glen)
            src_genome.append(g)
            src_kind.append(1)
            at += glen
    if n_host:
        bufs.append(host_genome(rng, srng, t, gen, device))
        pair_src.append((np.asarray([len(src_len)]), n_host))
        src_start.append(at)
        src_len.append(int(t["host_bp"]))
        src_genome.append(-1)
        src_kind.append(2)
    buf = torch.cat(bufs) if len(bufs) > 1 else bufs[0]
    del bufs

    # each pair's source: its group's count, a replicon by length
    ids, cnt = [], []
    for srcs, c in pair_src:
        ids.append(srcs)
        cnt.append(c)
    group = np.repeat(np.arange(len(ids)), cnt)
    src_len_a = np.asarray(src_len, np.int64)
    sid = np.empty(n_pairs, np.int64)
    for gi, srcs in enumerate(ids):
        sel = np.flatnonzero(group == gi)
        if len(srcs) == 1:
            sid[sel] = srcs[0]
        else:
            p = src_len_a[srcs] / src_len_a[srcs].sum()
            sid[sel] = srcs[np.searchsorted(np.cumsum(p),
                                            rng.random(len(sel)),
                                            side="right").clip(
                                                max=len(srcs) - 1)]
    sid = sid[rng.permutation(n_pairs)]
    d_sid = torch.as_tensor(sid).to(device)
    d_start = torch.as_tensor(np.asarray(src_start, np.int64)).to(device)
    d_len = torch.as_tensor(src_len_a).to(device)
    ins_lo, ins_hi = t["insert_bp"]
    span = d_len[d_sid] - ins_hi
    u = torch.rand(n_pairs, generator=gen, device=device,
                   dtype=torch.float64)
    pos = (u * span.to(torch.float64)).to(torch.int64)
    ins = torch.randint(ins_lo, ins_hi + 1, (n_pairs,), generator=gen,
                        device=device)
    j = torch.arange(rl, device=device)
    base = d_start[d_sid] + pos
    r1 = buf[base[:, None] + j]
    comp = torch.arange(256, dtype=torch.uint8, device=device)
    for a, b in COMP.items():
        comp[a] = b
    r2 = comp[buf[(base + ins - rl)[:, None] + j].to(torch.int64)].flip(1)
    swap = torch.rand(n_pairs, generator=gen, device=device) < \
        t["strand_swap"]
    r1, r2 = torch.where(swap[:, None], r2, r1), \
        torch.where(swap[:, None], r1, r2)
    out = []
    for r in (r1, r2):
        hit = torch.rand(r.shape, generator=gen, device=device) < \
            t["substitution_rate"]
        out.append(torch.where(hit, G.uniform_bases(r.numel(), gen, device)
                               .reshape(r.shape), r))
    kind = torch.as_tensor(np.asarray(src_kind, np.int8)).to(device)[d_sid]
    gen_of = torch.as_tensor(np.asarray(src_genome, np.int32)) \
        .to(device)[d_sid]
    return out[0], out[1], kind, gen_of


NAME_DIGITS = 8


def read_names(n: int):
    """The pairs' names, as the FASTQ holds them."""
    return [f"p{i:0{NAME_DIGITS}d}" for i in range(n)]


def fastq_bytes(reads: torch.Tensor) -> torch.Tensor:
    """The FASTQ records of reads [P, L] (u8 ASCII) as one u8 tensor:
    "@p<8 digits>\\n<bases>\\n+\\n<I x L>\\n" a record."""
    p, rl = reads.shape
    dev = reads.device
    rec = torch.empty((p, 1 + 1 + NAME_DIGITS + 1 + rl + 3 + rl + 1),
                      dtype=torch.uint8, device=dev)
    rec[:, 0] = ord("@")
    rec[:, 1] = ord("p")
    i = torch.arange(p, dtype=torch.int64, device=dev)
    for d in range(NAME_DIGITS):
        rec[:, 2 + d] = (ord("0") + (i // 10 ** (NAME_DIGITS - 1 - d)) % 10) \
            .to(torch.uint8)
    at = 2 + NAME_DIGITS
    rec[:, at] = ord("\n")
    rec[:, at + 1:at + 1 + rl] = reads
    at += 1 + rl
    rec[:, at:at + 3] = torch.tensor(list(b"\n+\n"), dtype=torch.uint8,
                                     device=dev)
    rec[:, at + 3:at + 3 + rl] = ord("I")
    rec[:, -1] = ord("\n")
    return rec.reshape(-1)


def write_fastq(path: str, reads: torch.Tensor) -> None:
    fastq_bytes(reads).cpu().numpy().tofile(path)
