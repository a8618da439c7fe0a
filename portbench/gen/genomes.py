"""Realistic bacterial genomes made on the device from a seed.

A rewrite in torch of kslam_tpu_torch/eval/realistic.py's model (that
module draws every base on the host with rng.choice, which would take
tens of seconds at 1.6 Gbp in every run's set-up).  It keeps the
properties its docstring lists, not its bytes:

  * GC heterogeneity: segments of gc_segment_bp bases, GC drawn in `gc`;
  * one rRNA-like operon master shared by every genome, operon_copies
    copies a genome at operon_divergence;
  * is_families IS-element masters; each genome carries
    is_families_per_genome of them, is_copies copies each at
    is_divergence (IS families recur across genomes, each in a share of
    them);
  * low-complexity tracts (homopolymers, 2-5 base microsatellites);
  * a shared plasmid, a separate entry with its host's taxid, carried by
    every plasmid_every-th genome;
  * genes tiling each entry (gene_bp long, gene_gap_bp apart).

What a genome holds is the configuration's, the same for every seed
(a numpy Generator on its structure_seed: copy counts, divergences, IS
families, tract kinds and lengths), so every seed does the same work;
where it lies and every base come from the run's seed (a numpy Generator
for segment lengths, positions and genes, a torch.Generator on the
device for the bases, in a few large calls).  Plants are written in
order (operons, IS copies, tracts), a later one over an earlier one, as
in realistic.py.
"""

from __future__ import annotations

import numpy as np
import torch

ACGT = b"ACGT"


def seeds(seed: int, stream: int):
    """(numpy Generator, torch seed) of one stream of a run's seed."""
    ss = np.random.SeedSequence([int(seed), stream])
    host, dev = ss.spawn(2)
    return (np.random.default_rng(host),
            int(dev.generate_state(1, np.uint64)[0]) & (2**63 - 1))


def device_generator(device, torch_seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(torch_seed)
    return g


def _lut(device):
    return torch.frombuffer(bytearray(ACGT), dtype=torch.uint8).to(device)


def uniform_bases(n: int, gen, device) -> torch.Tensor:
    """n bases, each of ACGT as likely."""
    idx = torch.randint(0, 4, (n,), generator=gen, device=device)
    return _lut(device)[idx]


def segmented(rng, lengths, gc_segment, gc_range, gen, device,
              block: int = 1 << 26) -> torch.Tensor:
    """Sequences of the given lengths, concatenated: GC drawn per segment
    of gc_segment bases (inclusive range), A = T = (1 - gc) / 2 and
    C = G = gc / 2."""
    starts, gcs = [], []
    pos = 0
    for n in lengths:
        end = pos + int(n)
        while pos < end:
            starts.append(pos)
            gcs.append(rng.uniform(*gc_range))
            pos += int(rng.integers(gc_segment[0], gc_segment[1] + 1))
        pos = end
    total = pos
    seg_start = torch.as_tensor(np.asarray(starts, np.int64)).to(device)
    seg_gc = torch.as_tensor(np.asarray(gcs, np.float32)).to(device)
    lut = _lut(device)
    out = torch.empty(total, dtype=torch.uint8, device=device)
    for a in range(0, total, block):
        b = min(a + block, total)
        p = torch.arange(a, b, dtype=torch.int64, device=device)
        g = seg_gc[torch.searchsorted(seg_start, p, right=True) - 1]
        del p
        u = torch.rand(b - a, generator=gen, device=device)
        idx = (u >= (1 - g) / 2).to(torch.uint8) + (u >= 0.5).to(torch.uint8)
        idx += (u >= 0.5 + g / 2).to(torch.uint8)
        out[a:b] = lut[idx.to(torch.int64)]
    return out


def mutated(master: torch.Tensor, divergence, gen) -> torch.Tensor:
    """Copies of master [L], one a divergence: each base replaced, with
    that probability, by a base drawn from ACGT.  Returns [C, L]."""
    dev = master.device
    d = torch.as_tensor(np.asarray(divergence, np.float32)).to(dev)
    c, length = d.shape[0], master.shape[0]
    copies = master[None, :].expand(c, length).clone()
    hit = torch.rand((c, length), generator=gen, device=dev) < d[:, None]
    repl = uniform_bases(c * length, gen, dev).reshape(c, length)
    return torch.where(hit, repl, copies)


def low_complexity(rng, length: int, device) -> torch.Tensor:
    """A homopolymer, or a microsatellite of a 2-5 base unit."""
    lut = np.frombuffer(ACGT, np.uint8)
    if rng.random() < 0.5:
        seq = np.full(length, lut[int(rng.integers(0, 4))], np.uint8)
    else:
        unit = lut[rng.integers(0, 4, int(rng.integers(2, 6)))]
        seq = np.tile(unit, length // len(unit) + 1)[:length]
    return torch.as_tensor(seq).to(device)


def _between(rng, lo_hi, n=None):
    lo, hi = lo_hi
    return rng.integers(lo, hi + 1, n)


def plant_repeats(rng, srng, seq: torch.Tensor, offsets, masters, p,
                  gen) -> None:
    """Write the operon copies, the IS copies and the low-complexity
    tracts into the chromosomes of `seq` (entry i spans offsets[i] to
    offsets[i + 1]), in that order a chromosome: what they are from the
    structure's generator srng, where from the seed's rng."""
    operon, is_masters = masters
    plants = []      # (global position, kind, divergence or tract)
    for i in range(len(offsets) - 1):
        start, length = int(offsets[i]), int(offsets[i + 1] - offsets[i])

        def at(n):
            return start + int(rng.integers(0, length - n))
        for _ in range(int(_between(srng, p["operon_copies"]))):
            plants.append((at(len(operon)), -1,
                           srng.uniform(*p["operon_divergence"])))
        fams = srng.choice(len(is_masters), p["is_families_per_genome"],
                           replace=False)
        for f in sorted(fams.tolist()):
            for _ in range(int(_between(srng, p["is_copies"]))):
                plants.append((at(len(is_masters[f])), f,
                               srng.uniform(*p["is_divergence"])))
        for _ in range(int(_between(srng, p["lc_tracts"]))):
            tract = low_complexity(srng, int(_between(srng, p["lc_bp"])),
                                   seq.device)
            plants.append((at(len(tract)), -2, tract))
    groups = {-1: operon, **dict(enumerate(is_masters))}
    content = {}
    for kind, master in groups.items():
        rows = [k for k, pl in enumerate(plants) if pl[1] == kind]
        if rows:
            copies = mutated(master, [plants[k][2] for k in rows], gen)
            content.update(zip(rows, copies))
    for k, (pos, kind, arg) in enumerate(plants):
        src = content[k] if kind != -2 else arg
        seq[pos:pos + src.shape[0]] = src


def gene_layout(rng, length: int, p):
    """(cds_start 1-based, cds_stop) of the genes tiling an entry."""
    glo, ghi = p["gene_bp"]
    n = length // (glo + p["gene_gap_bp"][0]) + 2
    glen = rng.integers(glo, ghi + 1, n)
    gap = rng.integers(p["gene_gap_bp"][0], p["gene_gap_bp"][1] + 1, n)
    pos = int(rng.integers(50, 400)) + np.concatenate(
        [[0], np.cumsum(glen + gap)[:-1]])
    keep = pos < length - 2000
    pos, glen = pos[keep], glen[keep]
    stop = np.minimum(pos + glen, length - 10)
    return pos + 1, stop


def layout(p: dict) -> dict:
    """What of the database the configuration alone fixes: offsets
    (int64 [E + 1]), taxids (int32 [E]), genome (int32 [E], the genome an
    entry belongs to), loci, taxonomy ({taxid: (parent, rank, name)}) and
    chrom_bp.  Entries: each genome's chromosome, then its plasmid if it
    carries one."""
    n, glen = p["genomes"], p["genome_bp"]
    lengths, genome, is_plasmid = [], [], []
    for g in range(n):
        lengths.append(glen)
        genome.append(g)
        is_plasmid.append(False)
        if g % p["plasmid_every"] == 0:
            lengths.append(p["plasmid_bp"])
            genome.append(g)
            is_plasmid.append(True)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    offsets[1:] = np.cumsum(lengths)
    genome = np.asarray(genome, np.int32)
    genera = p["genera"]
    taxonomy = {1: (1, "no rank", "root"), 2: (1, "superkingdom", "Bacteria")}
    for j in range(genera):
        taxonomy[1000 + j] = (2, "genus", f"Synthus{j}")
    for g in range(n):
        taxonomy[100000 + g] = (1000 + g % genera, "species",
                                f"Synthus{g % genera} realisticus {g}")
    loci = [f"{'RP' if pls else 'RG'}{g:05d}.1"
            for g, pls in zip(genome.tolist(), is_plasmid)]
    return dict(offsets=offsets, taxids=(100000 + genome).astype(np.int32),
                genome=genome, loci=loci, taxonomy=taxonomy, chrom_bp=glen)


def make_db(p: dict, seed: int, device):
    """The configuration's database from the seed: layout(p) with bases
    (u8 ASCII [G] on device) and genes (per entry (cds_start, cds_stop))."""
    rng, tseed = seeds(seed, 1)
    srng = np.random.default_rng(p["structure_seed"])
    gen = device_generator(device, tseed)
    n, glen = p["genomes"], p["genome_bp"]
    operon = uniform_bases(p["operon_bp"], gen, device)
    is_masters = [uniform_bases(p["is_bp"], gen, device)
                  for _ in range(p["is_families"])]
    plasmid = segmented(rng, [p["plasmid_bp"]], p["gc_segment_bp"], p["gc"],
                        gen, device)
    chrom = segmented(rng, [glen] * n, p["gc_segment_bp"], p["gc"], gen,
                      device)
    chrom_off = np.arange(n + 1, dtype=np.int64) * glen
    plant_repeats(rng, srng, chrom, chrom_off, (operon, is_masters), p, gen)
    carriers = [g for g in range(n) if g % p["plasmid_every"] == 0]
    plasmids = dict(zip(carriers, mutated(
        plasmid, [p["plasmid_divergence"]] * len(carriers), gen)))
    parts = []
    for g in range(n):
        parts.append(chrom[g * glen:(g + 1) * glen])
        if g in plasmids:
            parts.append(plasmids[g])
    db = layout(p)
    db["bases"] = torch.cat(parts)
    db["genes"] = [gene_layout(rng, int(le), p)
                   for le in np.diff(db["offsets"])]
    return db
