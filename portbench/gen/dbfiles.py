"""The database directory in the port's on-disk format, written from a
generated database (gen/genomes.py) and its index (gen/index.py):

  genomes.npz     bases u8, offsets int64, taxids int32, genbank_ids int64
  meta.json       per entry: locus_tag, definition, genes (Gene fields)
  kmer_index.npz  kmers u64, entry_id int32, offset int32, rc bool
  taxDB           4 lines a node: taxid, parent, name, rank

These are the files kslam_tpu_torch's GenbankIndex.save, KmerIndex.save
and TaxonomyDB.write_index write; the program loads them with its own
loaders.
"""

from __future__ import annotations

import os

import numpy as np

PRODUCTS = ("hypothetical protein", "DNA-binding protein",
            "ABC transporter permease", "50S ribosomal protein L2",
            "transposase", "DNA polymerase III subunit beta")


def gene_json(entry: int, starts, stops, first_id: int) -> str:
    """The JSON list of an entry's genes, as GenbankIndex.save writes
    dataclasses.asdict(Gene) (every field, in the dataclass's order)."""
    out = []
    for k, (a, b) in enumerate(zip(starts.tolist(), stops.tolist())):
        gid = first_id + k
        out.append(
            '{"gene_name": "gn%d", "locus_tag": "LT%05d_%d", '
            '"protein_id": "WP_%09d.1", "product": "%s", '
            '"reference_sequence": "NC_%06d", "gene_id": %d, '
            '"cds_start": %d, "cds_stop": %d, "count": 1}'
            % (gid, entry, k, gid, PRODUCTS[gid % len(PRODUCTS)], entry,
               gid, a, b))
    return "[" + ", ".join(out) + "]"


def write_taxonomy(path: str, taxonomy: dict) -> None:
    with open(path, "w") as fh:
        fh.write("".join(f"{t}\n{parent}\n{name}\n{rank}\n"
                         for t, (parent, rank, name) in taxonomy.items()))


def write_db(root: str, db: dict, index) -> None:
    """Write the database directory `root`; index = (kmers, entry_id,
    offset, rc) host arrays."""
    os.makedirs(root, exist_ok=True)
    bases = db["bases"].cpu().numpy()
    np.savez(os.path.join(root, "genomes.npz"), bases=bases,
             offsets=db["offsets"], taxids=db["taxids"],
             genbank_ids=np.arange(len(db["taxids"]), dtype=np.int64) +
             20000)
    del bases
    parts, gid = [], 0
    for e, (locus, (s, t)) in enumerate(zip(db["loci"], db["genes"])):
        parts.append('{"locus_tag": "%s", "definition": "%s", "genes": %s}'
                     % (locus, f"Synthus genome {db['genome'][e]}",
                        gene_json(e, s, t, gid)))
        gid += len(s)
    with open(os.path.join(root, "meta.json"), "w") as fh:
        fh.write("[" + ", ".join(parts) + "]")
    kmers, entry, off, rc = index
    np.savez(os.path.join(root, "kmer_index.npz"), kmers=kmers,
             entry_id=entry, offset=off, rc=rc)
    write_taxonomy(os.path.join(root, "taxDB"), db["taxonomy"])


def read_db(root: str):
    """(bases u8, offsets int64, index (kmers, entry_id, offset, rc)) of
    a database directory written by write_db."""
    g = np.load(os.path.join(root, "genomes.npz"))
    k = np.load(os.path.join(root, "kmer_index.npz"))
    return g["bases"], g["offsets"], (k["kmers"], k["entry_id"],
                                      k["offset"], k["rc"])
