"""kslam_tpu_torch.db.gbff.index_from_gbff (linear time) against
kslam_tpu.db.genbank.index_from_gbff, field by field on every entry and
gene: on tests/test_io.py's GBFF, on eval/realistic entries written by
eval/ncbi_mirror, on an edge corpus of the parser's grammar and on
files drawn by hypothesis from that grammar.  Inputs stay small: the
reference's parser is quadratic in an entry's length."""

import dataclasses
import os
import tempfile

import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kslam_tpu.db import genbank as jgenbank
from kslam_tpu_torch.db import gbff
from kslam_tpu_torch.eval import ncbi_mirror, realistic
from tests.test_io import GBFF

torch.set_num_threads(1)


def assert_same_index(paths):
    """Both parsers on `paths`: the same entries, every field of every
    GenbankEntry and Gene equal.  Returns the port's index."""
    mine = gbff.index_from_gbff(paths)
    ref = jgenbank.index_from_gbff(paths)
    assert len(mine.entries) == len(ref.entries)
    for m, r in zip(mine.entries, ref.entries):
        names = [f.name for f in dataclasses.fields(r)]
        assert [f.name for f in dataclasses.fields(m)] == names
        for name in names:
            if name != "genes":
                assert getattr(m, name) == getattr(r, name), name
        assert len(m.genes) == len(r.genes)
        for mg, rg in zip(m.genes, r.genes):
            assert dataclasses.asdict(mg) == dataclasses.asdict(rg)
    return mine


ENTRY_A = """LOCUS       EDGE_A                  75 bp    DNA     linear   BCT
DEFINITION  Edge case entry one, with a definition that runs on
            over two lines.
VERSION     EDGE_A.1  GI:777
KEYWORDS    .
FEATURES             Location/Qualifiers
     source          1..75
                     /organism="Edgeus primus"
                     /db_xref="taxon:4242"
     gene            complement(10..40)
                     /gene="edgA"
                     /locus_tag="EA_1"
     CDS             complement(10..40)
                     /gene="edgA"
                     /locus_tag="EA_1"
                     /product="a protein whose product name runs
                     over two lines"
                     /protein_id="WP_000000001.1"
                     /db_xref="GeneID:1001"
     CDS             join(3..8,50..70)
                     /gene="edgB"
                     /product="joined"
                     /protein_id="WP_2.1"
     CDS             3..8
                     /gene="edgB2"
                     /protein_id="WP_000000002.1"
     tRNA            <44..>60
                     /product="tRNA-Ala"
     gene            1..2
ORIGIN
        1 acgtnacgta cgtACGTNNN ggccttaagg ccttaaggcc ttaaggcctt aaggccttaa

       61 gcatgcatNn gcat
//
"""

# no ORIGIN; no taxon xref; a VERSION without GI
ENTRY_B = """LOCUS       EDGE_B
DEFINITION  No sequence.
VERSION     EDGE_B.3
FEATURES             Location/Qualifiers
     source          1..10
                     /organism="Edgeus secundus"
     CDS             1..9
                     /protein_id="X"
//
"""

# a last entry without '//' (dropped); blank and all-space lines
ENTRY_C = """LOCUS       EDGE_C
   \n
VERSION     EDGE_C.1  GI:12
ORIGIN
        1 acgtacgtac
"""


def _write(root, name, text):
    path = os.path.join(root, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def _realistic(root):
    entries = realistic.make_realistic_entries(
        n_genomes=2, bp_each=12_000, seed=3, plasmid_bp=3_000)
    path = os.path.join(root, "realistic.gbff")
    ncbi_mirror.write_gbff(path, realistic.entries_to_gbff_dicts(entries))
    return [path]


def _spread(root):
    taxa = ncbi_mirror.genus_taxa(3, 2)
    paths = []
    for g in range(3):
        path = os.path.join(root, f"spread{g}.gbff")
        ncbi_mirror.write_gbff(path, ncbi_mirror.spread_assembly(
            g, 15_000 + 4_000 * g, taxa, seed=5, plasmid=g == 0))
        paths.append(path)
    return paths


CORPORA = {
    "test_io": lambda root: [_write(root, "io.gbff", GBFF)],
    "realistic": _realistic,
    "spread_assemblies": _spread,
    "edge_one_file": lambda root: [_write(root, "edge.gbff",
                                          ENTRY_A + "\n" + ENTRY_B + ENTRY_C)],
    "edge_files": lambda root: [_write(root, "a.gbff", ENTRY_C),
                                _write(root, "b.gbff", ENTRY_B + ENTRY_A),
                                _write(root, "c.gbff", GBFF + ENTRY_C)],
    "no_final_newline": lambda root: [_write(root, "n.gbff",
                                             ENTRY_A + ENTRY_B.rstrip("\n"))],
    "empty": lambda root: [_write(root, "e.gbff", "")],
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
def test_gbff_entries_equal_reference(tmp_path, corpus):
    paths = CORPORA[corpus](str(tmp_path))
    index = assert_same_index(paths)
    if corpus == "edge_one_file":
        a, b = index.entries
        assert a.bases == "".join([
            "ACGTNACGTA", "CGTACGTNNN", "GGCCTTAAGG", "CCTTAAGGCC",
            "TTAAGGCCTT", "AAGGCCTTAA", "GCATGCATNN", "GCAT"])
        assert [g.cds_start for g in a.genes] == [1, 3, 10, 44]
        assert a.genes[1].protein_id == "WP_000000002.1"
        assert (b.bases, b.taxonomy_id, b.genbank_id) == ("", 0, 0)
    if corpus in ("realistic", "spread_assemblies"):
        assert sum(len(e.genes) for e in index.entries) >= 10


_TAGS = ["LOCUS", "DEFINITION", "VERSION", "KEYWORDS", "SOURCE",
         "REFERENCE", "FEATURES", "ORIGIN", "//", "1", "61", "ORIGINAL"]
_FEATURES = ["source", "CDS", "tRNA", "gene", "rRNA", "misc_feature"]
_LOCATIONS = ["{a}..{b}", "complement({a}..{b})", "join({a}..{b},{b}..9)",
              "<{a}..>{b}", "{a}", "complement(join({a}..5,{b}..{b}))"]
_QUALIFIERS = ['/product="{v}"', '/protein_id="{v}"', '/locus_tag="{v}"',
               '/gene="{v}"', '/db_xref="GeneID:{n}"',
               '/db_xref="taxon:{n}"', '/db_xref="taxon:{v}"',
               '/product="{v}', '/note={v}']
_WORD = st.text(alphabet="abcXYZ019 ._-", max_size=12)
_SPACES = st.integers(0, 14).map(lambda n: " " * n)


@st.composite
def _feature(draw):
    loc = draw(st.sampled_from(_LOCATIONS)).format(
        a=draw(st.integers(0, 300)), b=draw(st.integers(0, 300)))
    lines = [" " * draw(st.integers(3, 6)) +
             draw(st.sampled_from(_FEATURES)) + " " * draw(
                 st.integers(1, 12)) + loc]
    for _ in range(draw(st.integers(0, 4))):
        q = draw(st.sampled_from(_QUALIFIERS)).format(
            v=draw(_WORD), n=draw(st.integers(0, 10**6)))
        lines.append(" " * draw(st.integers(12, 24)) + q)
    return lines


@st.composite
def _sequence(draw):
    lines = ["ORIGIN"] if draw(st.booleans()) else []
    pos = 1
    for _ in range(draw(st.integers(0, 5))):
        bases = draw(st.text(alphabet="acgtnACGTN", max_size=60))
        groups = " ".join(bases[j:j + 10] for j in range(0, len(bases), 10))
        lines.append(draw(st.sampled_from(["{:>9} ", "{} ", "{}"]))
                     .format(pos) + groups)
        pos += len(bases)
    return lines


@st.composite
def _line(draw):
    kind = draw(st.integers(0, 5))
    if kind == 0:
        return [draw(st.sampled_from(_TAGS)) + draw(_SPACES) + draw(_WORD)]
    if kind == 1:
        return ["VERSION" + draw(_SPACES) + draw(_WORD) +
                draw(st.sampled_from(["  GI:", " GI:x", " ", ""])) +
                str(draw(st.integers(0, 10**9)))]
    if kind == 2:
        return draw(_feature())
    if kind == 3:
        return draw(_sequence())
    if kind == 4:
        return [draw(st.sampled_from(["", "   ", "//", "ORIGIN"]))]
    return [draw(_SPACES) + draw(st.text(
        alphabet='acgt0123456789/:"=()., <>_ABCDEFGHIJKLMNOPQRSTUVWXYZ',
        max_size=40))]


@st.composite
def _gbff_text(draw):
    entries = []
    for _ in range(draw(st.integers(0, 4))):
        lines = [line for part in draw(st.lists(_line(), max_size=12))
                 for line in part]
        if draw(st.integers(0, 4)):
            lines.append("//")
        entries.append("\n".join(lines) + "\n")
    return "".join(entries)


@settings(max_examples=150, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(_gbff_text(), min_size=1, max_size=3))
def test_gbff_grammar_equal_reference(texts):
    """Files drawn from the section grammar (tags at 0-14 leading spaces,
    continuations, features with every location form, sequence lines
    with and without ORIGIN, blank lines, missing '//' and quotes): the
    same entries as the reference's parser."""
    with tempfile.TemporaryDirectory() as root:
        assert_same_index([_write(root, f"f{i}.gbff", t)
                           for i, t in enumerate(texts)])
