"""Per-read taxon assignment + result combination (MetagenomicResults.h).

The per-read LCA over hit entries and the best-overlap gene query mirror
getResultFromPairedOverlaps (MetagenomicResults.h:88-111); combination per
taxonomyID mirrors combineTaxonomies (MetagenomicResults.h:117-176)
including the taxID-0 drop.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..db.genbank import Gene, GenbankIndex
from ..db.taxonomy import TaxonomyDB
from ..utils import metrics
from .pairing import ReadPairAlignments


@dataclasses.dataclass
class IdentifiedTaxonomy:
    """MetagenomicResults.h:32-42."""
    taxonomy_id: int = 0
    reads: List[str] = dataclasses.field(default_factory=list)
    genes: List[Gene] = dataclasses.field(default_factory=list)


def result_from_read_pair(read_pair: ReadPairAlignments,
                          index: GenbankIndex, read_names,
                          taxdb: TaxonomyDB) -> IdentifiedTaxonomy:
    """MetagenomicResults.h:88-111: collect hit-entry taxIDs + best genes,
    unique genes (fuzzy equality after geneSort), LCA the taxIDs."""
    result = IdentifiedTaxonomy()
    if not read_pair.pairs:
        return result
    entries = index.entries
    device_lca = getattr(read_pair, "device_lca", None)
    taxids = [] if device_lca is None else None
    for pair in read_pair.pairs:
        entry = entries[pair.entry_id]
        if taxids is not None:
            taxids.append(entry.taxonomy_id)
        if entry.genes:
            gene = entry.get_gene(pair.ref_start, pair.ref_end)
            if gene is not None:
                result.genes.append(dataclasses.replace(gene))
    if result.genes:
        result.genes.sort(key=lambda g: g.sort_key())
        unique: List[Gene] = []
        for gene in result.genes:  # std::unique: compare vs last kept
            if unique and unique[-1].same_gene(gene):
                continue
            unique.append(gene)
        result.genes = unique
    result.reads.append(read_names[read_pair.r1_pos])
    # the device pipeline already computed this read's LCA on chip
    # (ops/lca.py, proven equal to the host walk in tests); reuse it
    # instead of a second pointer-chase per read
    result.taxonomy_id = device_lca if device_lca is not None \
        else taxdb.lowest_common_ancestor(taxids)
    return result


def convert_alignments_to_taxonomies(
        reads_and_pairs: List[ReadPairAlignments], index: GenbankIndex,
        read_names, taxdb: TaxonomyDB) -> List[IdentifiedTaxonomy]:
    """MetagenomicResults.h:182-197 (the parallel transform, host-side)."""
    return [result_from_read_pair(rp, index, read_names, taxdb)
            for rp in reads_and_pairs]


class ChunkTaxa:
    """Columnar block of per-read results for one chunk.

    Equivalent to List[IdentifiedTaxonomy] where every result holds
    exactly one read (the shape the pipeline always produces,
    MetagenomicResults.h:88-111), stored as parallel arrays: building
    262k dataclass objects per chunk cost more host time than the whole
    device phase B.  `genes` is sparse: group ordinal -> unique gene
    list, populated only for rows whose entry carries annotations."""

    __slots__ = ("names", "taxids", "genes")

    def __init__(self, names, taxids, genes=None):
        self.names = list(names)
        self.taxids = np.asarray(taxids, dtype=np.uint32)
        self.genes = genes or {}

    def __len__(self):
        return len(self.names)

    def __getstate__(self):
        return (self.names, self.taxids, self.genes)

    def __setstate__(self, state):
        self.names, self.taxids, self.genes = state

    def objects(self) -> List[IdentifiedTaxonomy]:
        """Materialize per-read IdentifiedTaxonomy objects (slow path;
        kept for consumers that need the object shape)."""
        return [IdentifiedTaxonomy(int(t), [n], self.genes.get(i, []))
                for i, (n, t) in enumerate(zip(self.names,
                                               self.taxids.tolist()))]


def chunk_taxa_from_device(b, read_names, index: GenbankIndex) -> ChunkTaxa:
    """Columnar taxonomy assignment straight from device phase-B columns.

    Replaces chunk_to_host_pairs + convert_alignments_to_taxonomies when
    no SAM output is requested: ONE device transfer of the surviving
    columns, one numpy group scan, and per-read Python work proportional
    to GENES only -- no per-pair and no per-read Python objects.
    Identical results to the object path: rows arrive sorted by read
    group in the same within-group order the object path iterates, the
    per-read LCA is the device value the object path already uses, and
    gene lookup/fuzzy-unique runs the very same entry.get_gene /
    same_gene code per surviving row (MetagenomicResults.h:88-111
    semantics; parity-tested end-to-end)."""
    return chunk_taxa_from_arrays(fetch_classify_arrays(b), read_names,
                                  index)


def fetch_classify_arrays(b):
    """Copy the surviving-pair columns classification needs to the host.
    phase_b_finish front-compacts the valid rows, so only the first
    `n` rows cross; the returned mask is all-true."""
    cols = b.cols
    n = int(cols.valid.sum())
    metrics.count("pairs_kept", n)
    return tuple(c[:n].cpu().numpy() for c in
                 (cols.valid, cols.group, cols.entry_id, cols.ref_start,
                  cols.ref_end, b.read_lca))


class GroupArrays(tuple):
    """Marker for the per-read (groups, lcas) transfer of gene-less
    databases (device_path.classify_transfer_last): groups are already in
    chunk order, one row per read with hits."""


def chunk_taxa_from_arrays(arrs, read_names, index: GenbankIndex
                           ) -> ChunkTaxa:
    """chunk_taxa_from_device on prefetched host arrays."""
    if isinstance(arrs, GroupArrays):
        groups, lcas = arrs
        return ChunkTaxa([read_names[g] for g in groups.tolist()],
                         lcas.astype(np.uint32))
    valid, group, ent, rs, re_, lca = arrs
    v = np.flatnonzero(valid)
    if not len(v):
        return ChunkTaxa([], np.zeros(0, np.uint32))
    groups = group[v]
    starts = np.flatnonzero(
        np.concatenate([[True], groups[1:] != groups[:-1]]))
    taxids = lca[v][starts].astype(np.uint32)
    names = [read_names[i] for i in groups[starts].tolist()]
    entries = index.entries
    entry_has_genes = np.fromiter((bool(e.genes) for e in entries),
                                  bool, len(entries))
    ent_v = ent[v]
    gene_rows = np.flatnonzero(
        entry_has_genes[np.clip(ent_v, 0, len(entries) - 1)])
    genes = {}
    if len(gene_rows):
        rs_v, re_v = rs[v], re_[v]
        grp_of = np.searchsorted(starts, gene_rows, side="right") - 1
        # batched interval query (db/genbank.GeneTable) instead of a
        # per-row Python scan over every gene of the entry -- same
        # max-overlap/first-seen result (GenbankTools.h:170-185)
        found = index.gene_table.query(ent_v[gene_rows], rs_v[gene_rows],
                                       re_v[gene_rows])
        for gi, gene in zip(grp_of.tolist(), found):
            if gene is not None:
                genes.setdefault(gi, []).append(dataclasses.replace(gene))
        for gi, gl in genes.items():
            gl.sort(key=lambda g: g.sort_key())
            unique: List[Gene] = []
            for gene in gl:
                if unique and unique[-1].same_gene(gene):
                    continue
                unique.append(gene)
            genes[gi] = unique
    return ChunkTaxa(names, taxids, genes)


def taxonomies_from_device(b, read_names, index: GenbankIndex
                           ) -> List[IdentifiedTaxonomy]:
    """Object-shaped variant of chunk_taxa_from_device (compat path)."""
    return chunk_taxa_from_device(b, read_names, index).objects()


def _combine_units(taxid: int, units) -> IdentifiedTaxonomy:
    """combineRangeOfIdentifiedTaxonomy (MetagenomicResults.h:117-143):
    concatenate, sort genes, manual unique incrementing count by one per
    duplicate element.  A unit is a plain read name (block row with no
    genes), a (name, genes) tuple (block row with genes), or an
    IdentifiedTaxonomy object."""
    combined = IdentifiedTaxonomy(taxid, [], [])
    for u in units:
        if isinstance(u, str):       # incl. numpy str_ subclasses
            combined.reads.append(str(u))
        elif isinstance(u, tuple):
            combined.reads.append(str(u[0]))
            combined.genes.extend(dataclasses.replace(g) for g in u[1])
        else:
            combined.reads.extend(u.reads)
            combined.genes.extend(dataclasses.replace(g) for g in u.genes)
    combined.genes.sort(key=lambda g: g.sort_key())
    out: List[Gene] = []
    for gene in combined.genes:
        if out and out[-1].same_gene(gene):
            out[-1].count += 1
        else:
            out.append(gene)
    combined.genes = out
    return combined


def combine_taxonomies(results) -> List[IdentifiedTaxonomy]:
    """combineTaxonomies (MetagenomicResults.h:149-176), mirrored exactly:
    taxID-0 groups (reads with no LCA) are dropped, and -- a reference quirk
    we preserve for parity -- when the sorted results do NOT start with a
    taxID-0 run, the very first row is lost at the first group transition
    (testTaxID starts at 0 and `start` is advanced without flushing,
    MetagenomicResults.h:159-170); a single-element input keeps its row
    (the loop body never runs, only the final flush does).

    `results` is a mixed sequence of IdentifiedTaxonomy objects and
    ChunkTaxa blocks (each block row is one per-read result, in chunk
    order) -- the grouping runs over numpy arrays so million-read runs
    never materialize per-read objects.

    The reference sort is __gnu_parallel::sort, which is UNSTABLE: which
    row among the smallest-taxID ties lands first (and is lost) depends on
    libstdc++ internals.  When the native helper (csrc/ref_sort.cc) is
    available we replay the exact permutation; otherwise a stable sort is
    used, which can differ from the reference binary in the single lost
    row (only its reads/genes vanish from the XML; PerRead/abbreviated
    outputs are unaffected because they are written pre-combine or count
    at taxon granularity)."""
    from ..io import native
    tax_parts = []
    units: List = []
    for item in results:
        if isinstance(item, ChunkTaxa):
            tax_parts.append(item.taxids)
            if item.genes:
                blk: List = list(item.names)
                for i, gl in item.genes.items():
                    blk[i] = (item.names[i], gl)
                units.extend(blk)
            else:
                units.extend(item.names)
        else:
            tax_parts.append(
                np.asarray([item.taxonomy_id], dtype=np.uint32))
            units.append(item)
    combined: List[IdentifiedTaxonomy] = []
    if not units:
        return combined
    taxids = np.concatenate(tax_parts).astype(np.uint32, copy=False)
    perm = native.ref_sort_perm(taxids)
    if perm is None:
        perm = np.argsort(taxids, kind="stable")
    t_sorted = taxids[perm]
    n = len(t_sorted)
    starts = np.flatnonzero(
        np.concatenate([[True], t_sorted[1:] != t_sorted[:-1]]))
    ends = np.append(starts[1:], n)
    for gi, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        taxid = int(t_sorted[s])
        if taxid == 0:
            continue
        if gi == 0 and n > 1:
            # first-row-loss quirk (see docstring); N == 1 keeps its row
            s += 1
            if s == e:
                continue
        combined.append(_combine_units(
            taxid, (units[j] for j in perm[s:e].tolist())))
    return combined
