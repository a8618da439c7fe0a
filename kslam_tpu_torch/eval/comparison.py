"""Offline accuracy evaluation (the reference's comparison.h).

Three entry points, matching the reference's behavior with a cleaned-up
I/O surface (they operated on hardcoded file names and stdout):

  * evaluate_results: per-read classifications vs a locus -> taxID truth
    map; per-true-taxon species/genus correct counts
    (comparison.h:252-355),
  * evaluate_overlaps: hit-list diagnostics for surviving alignment pairs
    -- does any (top-scoring) hit carry the correct species
    (comparison.h:151-251),
  * mcnemar: McNemar chi-square significance between two tools'
    per-read species-level correctness (comparison.h:40-150; generalized
    from its hardcoded kraken/phymmBL/SLAM/NBC/RITA file list).

Locus extraction from a read/sequence identifier keeps the reference rule:
everything before the first '.', ' ' or tab (comparison.h:70-71).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from ..db.taxonomy import TaxonomyDB


def read_locus_to_taxid(path: str) -> Dict[str, int]:
    """Truth map: `locus\ttaxID` per line; parsing stops at the first
    malformed line (comparison.h:46-49 `break` semantics)."""
    out: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            tokens = line.rstrip("\n").rstrip("\r").split("\t")
            if len(tokens) < 2:
                break
            out[tokens[0]] = int(tokens[1])
    return out


def locus_of(seq_id: str) -> str:
    for i, c in enumerate(seq_id):
        if c in ". \t":
            return seq_id[:i]
    return seq_id


@dataclasses.dataclass
class TaxonAccuracy:
    taxid: int
    name: str
    num_species_correct: int = 0
    num_genus_correct: int = 0


@dataclasses.dataclass
class EvalSummary:
    per_taxon: Dict[int, TaxonAccuracy]
    num_incorrect: int
    num_reads: int

    @property
    def species_correct(self) -> int:
        return sum(t.num_species_correct for t in self.per_taxon.values())

    @property
    def genus_correct(self) -> int:
        return sum(t.num_genus_correct for t in self.per_taxon.values())


def _iter_per_read_file(path: str):
    with open(path) as f:
        for line in f:
            tokens = line.rstrip("\n").rstrip("\r").split("\t")
            if len(tokens) < 2:
                continue
            yield tokens[0], int(tokens[1])


def evaluate_results(per_read: Iterable[Tuple[str, int]] | str,
                     truth: Dict[str, int] | str,
                     taxdb: TaxonomyDB,
                     out_path: Optional[str] = None) -> EvalSummary:
    """Species/genus accuracy of (seq_id, predicted_taxid) classifications.

    Mirrors comparison.h:252-355: a prediction only counts (correct or
    incorrect) at a rank when it maps to that rank at all; unknown loci
    evaluate against taxID 0.
    """
    if isinstance(truth, str):
        truth = read_locus_to_taxid(truth)
    if isinstance(per_read, str):
        per_read = _iter_per_read_file(per_read)
    per_taxon: Dict[int, TaxonAccuracy] = {}
    num_incorrect = 0
    num_reads = 0
    for seq_id, predicted in per_read:
        num_reads += 1
        actual = truth.get(locus_of(seq_id), 0)
        actual_sp = taxdb.get_taxid_at_rank(actual, "species")
        actual_ge = taxdb.get_taxid_at_rank(actual, "genus")
        pred_sp = taxdb.get_taxid_at_rank(predicted, "species")
        pred_ge = taxdb.get_taxid_at_rank(predicted, "genus")
        acc = per_taxon.setdefault(
            actual, TaxonAccuracy(actual, taxdb.get_name(actual)))
        if pred_sp:
            if pred_sp == actual_sp:
                acc.num_species_correct += 1
            else:
                num_incorrect += 1
        if pred_ge and pred_ge == actual_ge:
            acc.num_genus_correct += 1
    if out_path:
        with open(out_path, "w") as out:
            for acc in per_taxon.values():
                out.write(f"{acc.name}\t{acc.num_species_correct}\t"
                          f"{acc.num_genus_correct}\n")
    return EvalSummary(per_taxon, num_incorrect, num_reads)


def evaluate_overlaps(reads_and_pairs, gindex, read_names: List[str],
                      truth: Dict[str, int] | str,
                      taxdb: TaxonomyDB) -> EvalSummary:
    """Hit-list diagnostics (comparison.h:151-251): a read counts as
    species-correct when ANY surviving alignment pair hits an entry of the
    true species (genus analogous)."""
    if isinstance(truth, str):
        truth = read_locus_to_taxid(truth)
    per_taxon: Dict[int, TaxonAccuracy] = {}
    num_incorrect = 0
    num_reads = 0
    for read in reads_and_pairs:
        if not read.pairs:
            continue
        num_reads += 1
        seq_id = read_names[read.pairs[0].r1.read_id
                            if read.pairs[0].r1 else
                            read.pairs[0].r2.read_id]
        actual = truth.get(locus_of(seq_id), 0)
        actual_sp = taxdb.get_taxid_at_rank(actual, "species")
        actual_ge = taxdb.get_taxid_at_rank(actual, "genus")
        species = genus = False
        for pair in sorted(read.pairs, key=lambda p: -p.combined_score):
            tid = gindex.entries[pair.entry_id].taxonomy_id
            if taxdb.get_taxid_at_rank(tid, "species") == actual_sp:
                species = genus = True
                break
            if taxdb.get_taxid_at_rank(tid, "genus") == actual_ge:
                genus = True
        acc = per_taxon.setdefault(
            actual, TaxonAccuracy(actual, taxdb.get_name(actual)))
        if species:
            acc.num_species_correct += 1
        else:
            num_incorrect += 1
        if genus:
            acc.num_genus_correct += 1
    return EvalSummary(per_taxon, num_incorrect, num_reads)


def mcnemar(tool_a: Iterable[Tuple[str, int]] | str,
            tool_b: Iterable[Tuple[str, int]] | str,
            truth: Dict[str, int] | str,
            taxdb: TaxonomyDB) -> Tuple[int, int, float]:
    """McNemar test of species-level correctness between two tools'
    per-read outputs.  Returns (n01, n10, chi-square with continuity
    correction) exactly as comparison.h:131-149 computes it: n01 = reads A
    got right and B missed."""
    if isinstance(truth, str):
        truth = read_locus_to_taxid(truth)

    def correctness(rows):
        if isinstance(rows, str):
            rows = _iter_per_read_file(rows)
        out: Dict[str, bool] = {}
        for seq_id, predicted in rows:
            seq_id = seq_id.rstrip(" ")
            actual = truth.get(locus_of(seq_id), 0)
            actual_sp = taxdb.get_taxid_at_rank(actual, "species")
            pred_sp = taxdb.get_taxid_at_rank(predicted, "species")
            prev = out.get(seq_id, False)
            out[seq_id] = prev or bool(pred_sp and pred_sp == actual_sp)
        return out

    a = correctness(tool_a)
    b = correctness(tool_b)
    n01 = n10 = 0
    for seq_id in set(a) | set(b):
        ca, cb = a.get(seq_id, False), b.get(seq_id, False)
        if ca and not cb:
            n01 += 1
        elif cb and not ca:
            n10 += 1
    chi = ((abs(n01 - n10) - 1) ** 2) / (n01 + n10) if n01 + n10 else 0.0
    return n01, n10, chi
