"""Realistic bacterial-genome stand-in generator (deterministic): the
port's copy of kslam_tpu/eval/realistic.py (pure numpy; the port cannot
import the reference package, whose __init__ imports jax).
tests/test_torch_port_guard.py holds the two equal.

Uniform random ACGT hides the properties that stress the engine on real
GenBank data.  This module generates genomes that reproduce them:

  * compositional heterogeneity: piecewise GC content over 5-50 kb
    segments (GC 28-68%), not one uniform base distribution,
  * rRNA-like operons: ONE ~5 kb master sequence shared by every genome
    (the classic inter-genomic repeat), 2-7 copies per genome at 0.5-2%
    divergence -> power-law k-mer pileups across entries,
  * IS-element families: three ~1.2 kb masters shared across genomes,
    5-25 copies each at 0-8% divergence -> intra-genomic repeats,
  * low-complexity tracts: homopolymer runs and (ACGGT)n microsatellites
    (exercises the all-A k-mer skip, Overlap.h:236-239, the
    low-complexity screen and the SW tie-break on equal-score ends),
  * a shared ~25 kb plasmid carried by half the genomes as a SEPARATE
    entry with the host's taxonomy id (multi-entry taxa, near-identical
    sequence across carriers),
  * dense gene annotation (~1 gene/kbp like real bacteria) when written
    as GBFF.

All sequence is drawn from a seeded Generator: runs are reproducible and
no binary blobs live in the repo.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class RealisticEntry:
    """One generated replicon (chromosome or plasmid)."""
    seq: np.ndarray          # uint8 ASCII
    taxid: int
    locus: str
    organism: str
    is_plasmid: bool = False


def _segmented_background(rng, length: int) -> np.ndarray:
    """Piecewise-GC random sequence: segments of 5-50 kb, GC 28-68%."""
    out = np.empty(length, np.uint8)
    pos = 0
    while pos < length:
        seg = int(rng.integers(5_000, 50_000))
        seg = min(seg, length - pos)
        gc = rng.uniform(0.28, 0.68)
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        out[pos:pos + seg] = BASES[rng.choice(4, seg, p=p)]
        pos += seg
    return out


def _mutated(rng, master: np.ndarray, divergence: float) -> np.ndarray:
    copy = master.copy()
    m = rng.random(len(copy)) < divergence
    copy[m] = BASES[rng.integers(0, 4, int(m.sum()))]
    return copy


def _plant(seq: np.ndarray, rng, insert: np.ndarray) -> None:
    """Overwrite a random window with `insert` (keeps length static)."""
    if len(insert) >= len(seq):
        return
    pos = int(rng.integers(0, len(seq) - len(insert)))
    seq[pos:pos + len(insert)] = insert


def _low_complexity(rng, length: int) -> np.ndarray:
    if rng.random() < 0.5:
        return np.full(length, BASES[int(rng.integers(0, 4))], np.uint8)
    unit = BASES[rng.integers(0, 4, int(rng.integers(2, 6)))]
    return np.tile(unit, length // len(unit) + 1)[:length]


def make_realistic_entries(n_genomes: int = 6, bp_each: int = 400_000,
                           seed: int = 0,
                           plasmid_bp: int = 25_000) -> List[RealisticEntry]:
    rng = np.random.default_rng(seed)
    rrna_master = BASES[rng.integers(0, 4, 5_000)]
    is_masters = [BASES[rng.integers(0, 4, 1_200)] for _ in range(3)]
    plasmid_master = _segmented_background(rng, plasmid_bp)
    entries: List[RealisticEntry] = []
    for g in range(n_genomes):
        seq = _segmented_background(rng, bp_each)
        for _ in range(int(rng.integers(2, 8))):        # rRNA operons
            _plant(seq, rng, _mutated(rng, rrna_master,
                                      rng.uniform(0.005, 0.02)))
        for master in is_masters:                        # IS elements
            for _ in range(int(rng.integers(5, 26))):
                _plant(seq, rng, _mutated(rng, master,
                                          rng.uniform(0.0, 0.08)))
        for _ in range(int(rng.integers(3, 9))):         # low complexity
            _plant(seq, rng,
                   _low_complexity(rng, int(rng.integers(200, 2_000))))
        taxid = 100 + g
        entries.append(RealisticEntry(
            seq=seq, taxid=taxid, locus=f"RG{g:04d}.1",
            organism=f"Synthus realisticus {g}"))
        if g % 2 == 0:                                   # shared plasmid
            entries.append(RealisticEntry(
                seq=_mutated(rng, plasmid_master, 0.005), taxid=taxid,
                locus=f"RP{g:04d}.1",
                organism=f"Synthus realisticus {g}", is_plasmid=True))
    return entries


def entries_to_gbff_dicts(entries: List[RealisticEntry],
                          genes_per_kbp: float = 1.0,
                          seed: int = 1) -> List[dict]:
    """golden_ref/parity.write_gbff-shaped dicts with dense genes
    (~1/kbp, real bacterial density; gene intervals tile the genome with
    gaps, occasionally overlapping like real operons)."""
    rng = np.random.default_rng(seed)
    out = []
    for i, e in enumerate(entries):
        genes = []
        pos = int(rng.integers(50, 400))
        gi = 0
        while pos < len(e.seq) - 2_000:
            glen = int(rng.integers(300, 1_800))
            stop = min(pos + glen, len(e.seq) - 10)
            genes.append((pos + 1, stop, f"g{i}_{gi}"))   # 1-based GBFF
            gi += 1
            pos = stop + max(int(rng.integers(
                30, max(int(2_000 / genes_per_kbp), 31))), 30)
        out.append(dict(locus=e.locus, gi=20_000 + i, taxid=e.taxid,
                        organism=e.organism,
                        seq=e.seq.tobytes().decode(), genes=genes))
    return out


def realistic_taxa(entries: List[RealisticEntry]) -> dict:
    """taxdump dict {taxid: (parent, rank, name)} for write_taxdump."""
    taxa = {2: (1, "superkingdom", "Bacteria"),
            90: (2, "genus", "Synthus")}
    for e in entries:
        if e.taxid not in taxa:
            taxa[e.taxid] = (90, "species", e.organism)
    return taxa


def pileup_stats(kmers_sorted: np.ndarray, prefix_bits: int = 26) -> dict:
    """Distribution stats of a sorted k-mer column: pileup (equal-k-mer
    run) sizes and prefix-run lengths -- the quantities that size the
    join window and the match fanout caps on skewed data."""
    m = len(kmers_sorted)
    if m == 0:
        return dict(n=0)
    change = np.flatnonzero(kmers_sorted[1:] != kmers_sorted[:-1])
    runs = np.diff(np.concatenate([[-1], change, [m - 1]]))
    tops = (kmers_sorted >> np.uint64(64 - prefix_bits)).astype(np.int64)
    pruns = np.bincount(tops, minlength=1)
    pruns = pruns[pruns > 0]
    return dict(
        n=m, distinct=len(runs),
        pileup_max=int(runs.max()),
        pileup_p99=float(np.percentile(runs, 99)),
        pileup_mean=float(runs.mean()),
        prefix_run_max=int(pruns.max()),
        prefix_run_p99=float(np.percentile(pruns, 99)),
    )
