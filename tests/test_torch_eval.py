"""kslam_tpu_torch.eval.comparison (the offline accuracy harness) against
kslam_tpu's on the inputs of tests/test_eval.py: the same EvalSummary
fields, accuracy file, loci and McNemar triple; evaluate_overlaps on
each package's own pairing objects."""

import dataclasses

import pytest

from kslam_tpu.db import genbank as jgenbank
from kslam_tpu.db.taxonomy import TaxonomyDB as JTaxonomyDB
from kslam_tpu.eval import comparison as jcomparison
from kslam_tpu.pipeline import pairing as jpairing
from kslam_tpu_torch.db import genbank as tgenbank
from kslam_tpu_torch.db.taxonomy import TaxonomyDB as TTaxonomyDB
from kslam_tpu_torch.eval import comparison as tcomparison
from kslam_tpu_torch.pipeline import pairing as tpairing

# 1 root -> 5 Bacteria -> 10 genusA -> 100 speciesA1 -> 1000 strainA1a
#                                   -> 101 speciesA2
#                      -> 20 genusB -> 200 speciesB1
ROWS = [(1, 1, "root", "no rank"), (5, 1, "Bacteria", "superkingdom"),
        (10, 5, "genusA", "genus"), (100, 10, "speciesA1", "species"),
        (1000, 100, "strainA1a", "no rank"),
        (101, 10, "speciesA2", "species"), (20, 5, "genusB", "genus"),
        (200, 20, "speciesB1", "species")]

# (package's comparison module, its TaxonomyDB, genbank, pairing)
PACKAGES = {"jax": (jcomparison, JTaxonomyDB, jgenbank, jpairing),
            "torch": (tcomparison, TTaxonomyDB, tgenbank, tpairing)}


def taxdb(cls):
    db = cls()
    for tid, parent, name, rank in ROWS:
        db.parent_of[tid] = parent
        db.name_of[tid] = name
        db.rank_of[tid] = rank
    return db


def summary_fields(s):
    return (s.num_incorrect, s.num_reads, s.species_correct,
            s.genus_correct,
            {k: dataclasses.asdict(v) for k, v in s.per_taxon.items()})


def both(fn):
    """fn(package tuple) for the reference and the port."""
    return fn(PACKAGES["jax"]), fn(PACKAGES["torch"])


@pytest.mark.parametrize("seq_id", ["NC_0001.1 extra", "plainlocus", "a b",
                                    "x\ty", ".lead", ""])
def test_locus_of(seq_id):
    ref, got = both(lambda p: p[0].locus_of(seq_id))
    assert got == ref


RESULT_CASES = {
    # truth, per-read predictions
    "mixed": ({"r1": 1000, "r2": 101, "r3": 200, "r4": 200},
              [("r1.x", 100), ("r2.x", 100), ("r3.x", 200), ("r4.x", 10)]),
    "unknown_loci": ({"r1": 100},
                     [("r1 a", 100), ("zz.1", 200), ("r1.b", 0),
                      ("q", 1000)]),
    "all_wrong": ({f"r{i}": 200 for i in range(6)},
                  [(f"r{i}.1", 101) for i in range(6)]),
}


@pytest.mark.parametrize("case", list(RESULT_CASES))
def test_evaluate_results_equals_reference(case, tmp_path):
    truth, rows = RESULT_CASES[case]

    def run(p):
        out = tmp_path / f"acc_{p[0].__name__}.tsv"
        s = p[0].evaluate_results(rows, truth, taxdb(p[1]),
                                  out_path=str(out))
        return summary_fields(s), out.read_text()
    ref, got = both(run)
    assert got == ref


def test_evaluate_results_from_files_equals_reference(tmp_path):
    """Truth and per-read TSVs given as paths; truth parsing stops at the
    first malformed line."""
    truth = tmp_path / "truth.tsv"
    truth.write_text("r1\t1000\nr2\t101\nbroken\nr3\t200\n")
    per_read = tmp_path / "per_read.tsv"
    per_read.write_text("r1.x\t100\nr2.x\t100\nskip\nr3.x\t200\n")
    ref, got = both(lambda p: summary_fields(p[0].evaluate_results(
        str(per_read), str(truth), taxdb(p[1]))))
    assert got == ref
    assert both(lambda p: p[0].read_locus_to_taxid(str(truth)))[0] == \
        {"r1": 1000, "r2": 101}


MCNEMAR_CASES = {
    "a_better": ([100 if i < 8 else 101 for i in range(10)],
                 [100 if i < 5 else 101 for i in range(10)]),
    "b_better": ([101] * 10, [100 if i % 2 else 101 for i in range(10)]),
    "equal": ([100] * 10, [100] * 10),
}


@pytest.mark.parametrize("case", list(MCNEMAR_CASES))
def test_mcnemar_equals_reference(case):
    pred_a, pred_b = MCNEMAR_CASES[case]
    truth = {f"r{i}": 100 for i in range(10)}
    a = [(f"r{i}", t) for i, t in enumerate(pred_a)]
    b = [(f"r{i} ", t) for i, t in enumerate(pred_b)]
    ref, got = both(lambda p: p[0].mcnemar(a, b, truth, taxdb(p[1])))
    assert got == ref


def test_evaluate_overlaps_equals_reference():
    def run(p):
        comparison, tax_cls, genbank, pairing = p
        gindex = genbank.GenbankIndex([
            genbank.GenbankEntry(bases="A" * 40, taxonomy_id=1000),
            genbank.GenbankEntry(bases="C" * 40, taxonomy_id=200),
            genbank.GenbankEntry(bases="G" * 40, taxonomy_id=101)])

        def mk(read_id, entry_id, score, r2=False):
            o = pairing.AlignedOverlap(
                read_id=read_id, entry_id=entry_id, rel_pos=0, rc=False,
                score=score, ref_begin=0, ref_end=10, query_begin=0,
                query_end=10)
            return pairing.PairedOverlap(score, entry_id, 0, 10, 0,
                                         None if r2 else o, o if r2 else None)
        reads = [
            pairing.ReadPairAlignments(0, 0, [mk(0, 0, 50)]),
            pairing.ReadPairAlignments(1, 1, [mk(1, 1, 50)]),
            # the top pair misses; a lower one hits the genus only
            pairing.ReadPairAlignments(2, 2, [mk(2, 1, 60), mk(2, 2, 40)]),
            pairing.ReadPairAlignments(3, 3, [mk(3, 0, 30, r2=True)]),
            pairing.ReadPairAlignments(4, 4, []),
        ]
        truth = {"q0": 100, "q1": 100, "q2": 100, "q3": 1000}
        return summary_fields(comparison.evaluate_overlaps(
            reads, gindex, ["q0.a", "q1.a", "q2.a", "q3.a", "q4.a"], truth,
            taxdb(tax_cls)))
    ref, got = both(run)
    assert got == ref
    assert got[:4] == (2, 4, 2, 3)
