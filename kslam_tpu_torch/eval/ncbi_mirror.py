"""A local NCBI mirror for the DB installer (kslam_tpu_torch.install_db),
made from a seed: the tree that the installer's URLs name, and a
stand-in for its `fetch` that reads that tree, so an install runs with
no network.

    <root>/pub/taxonomy/taxdump.tar.gz         names.dmp, nodes.dmp
    <root>/genomes/refseq/<group>/assembly_summary.txt
    <root>/genomes/all/GCF/<3>/<3>/<3>/<name>/<name>_genomic.gbff.gz

`assembly_summary.txt` has the 23 tab-separated columns of NCBI's (the
installer reads version_status from column 10, assembly_level from 11
and ftp_path from 19).  The GBFF and taxdump writers are copies of
golden_ref/parity.py's (tests/test_torch_port_guard.py holds them
equal).  `spread_assembly` makes one RefSeq-like bacterial assembly from
eval/realistic's pieces, at a length of its own: a chromosome, maybe the
shared plasmid, ~0.86 genes a kbp.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import shutil
import statistics
import tarfile
import tempfile
import urllib.parse
import zipfile
from typing import Dict, List, Tuple

import numpy as np

from . import realistic

NCBI = "https://ftp.ncbi.nlm.nih.gov"
SUMMARY_HEADER = (
    "assembly_accession", "bioproject", "biosample", "wgs_master",
    "refseq_category", "taxid", "species_taxid", "organism_name",
    "infraspecific_name", "isolate", "version_status", "assembly_level",
    "release_type", "genome_rep", "seq_rel_date", "asm_name", "submitter",
    "gbrs_paired_asm", "paired_asm_comp", "ftp_path",
    "excluded_from_refseq", "relation_to_type_material",
    "asm_not_live_date")
SUMMARY_COLUMNS = len(SUMMARY_HEADER)


_GBFF_TEMPLATE = """LOCUS       {locus}             {length} bp    DNA     linear   BCT
DEFINITION  {definition}.
VERSION     {locus}  GI:{gi}
FEATURES             Location/Qualifiers
     source          1..{length}
                     /organism="{organism}"
                     /db_xref="taxon:{taxid}"
{genes}ORIGIN
{origin}//
"""

_GENE_TEMPLATE = """     gene            {start}..{stop}
                     /gene="{gene}"
                     /locus_tag="{ltag}"
     CDS             {start}..{stop}
                     /gene="{gene}"
                     /locus_tag="{ltag}"
                     /product="{product}"
                     /protein_id="{protein}"
                     /db_xref="GeneID:{geneid}"
"""


def _origin_block(seq: str) -> str:
    out = []
    for i in range(0, len(seq), 60):
        chunk = seq[i:i + 60].lower()
        groups = " ".join(chunk[j:j + 10] for j in range(0, len(chunk), 10))
        out.append(f"{i + 1:>9} {groups}\n")
    return "".join(out)


def write_gbff(path: str, entries: List[dict]) -> None:
    """entries: [{locus, gi, taxid, organism, seq, genes:[(start,stop,name)]}]
    starts/stops are 1-based inclusive like real GBFF."""
    with open(path, "w") as fh:
        for k, e in enumerate(entries):
            genes = "".join(
                _GENE_TEMPLATE.format(
                    start=s, stop=t, gene=n, ltag=f"LT{e['gi']}_{j}",
                    product=f"{n} product", protein=f"P{e['gi']}_{j}.1",
                    geneid=e["gi"] * 100 + j)
                for j, (s, t, n) in enumerate(e["genes"]))
            fh.write(_GBFF_TEMPLATE.format(
                locus=e["locus"], length=len(e["seq"]), gi=e["gi"],
                definition=e.get("definition", f"{e['organism']} genome"),
                organism=e["organism"], taxid=e["taxid"], genes=genes,
                origin=_origin_block(e["seq"])))


def write_taxdump(names_path: str, nodes_path: str,
                  taxa: Dict[int, Tuple[int, str, str]]) -> None:
    """taxa: taxid -> (parent, rank, scientific name); root (1) implied."""
    with open(nodes_path, "w") as fh:
        fh.write("1\t|\t1\t|\tno rank\t|\n")
        for tid, (parent, rank, _) in sorted(taxa.items()):
            fh.write(f"{tid}\t|\t{parent}\t|\t{rank}\t|\n")
    with open(names_path, "w") as fh:
        fh.write("1\t|\troot\t|\t\t|\tscientific name\t|\n")
        for tid, (_, _, name) in sorted(taxa.items()):
            fh.write(f"{tid}\t|\t{name}\t|\t\t|\tscientific name\t|\n")


# --- the mirror's tree ---

@dataclasses.dataclass
class Assembly:
    """One assembly_summary.txt row of the mirror: genome g (taxid
    100 + g, spread_assembly's) in `group`.  listed_path False writes
    NCBI's "na" for its ftp_path (its file is still in the tree)."""
    g: int
    length: int
    group: str = "bacteria"
    plasmid: bool = False
    version_status: str = "latest"
    assembly_level: str = "Complete Genome"
    listed_path: bool = True

    @property
    def accession(self) -> str:
        return f"GCF_{self.g + 1:09d}.1"

    @property
    def asm_name(self) -> str:
        return f"ASM{self.g + 1}v1"

    @property
    def ftp_path(self) -> str:
        """NCBI's ftp_path of the assembly: .../GCF/000/000/001/<name>."""
        digits = self.accession[4:13]
        return (f"{NCBI}/genomes/all/GCF/{digits[0:3]}/{digits[3:6]}/"
                f"{digits[6:9]}/{self.accession}_{self.asm_name}")

    @property
    def gbff_url(self) -> str:
        return (f"{self.ftp_path}/{self.accession}_{self.asm_name}"
                f"_genomic.gbff.gz")

    @property
    def installed(self) -> bool:
        """Whether install_db.download_genomes fetches it: the latest
        version, a listed path, and for bacteria a complete genome."""
        return (self.version_status == "latest" and self.listed_path and
                (self.group != "bacteria" or
                 self.assembly_level == "Complete Genome"))

    def summary_row(self, organism: str) -> str:
        cols = [""] * SUMMARY_COLUMNS
        cols[0], cols[4], cols[5], cols[6] = self.accession, "na", \
            str(100 + self.g), str(100 + self.g)
        cols[7], cols[10], cols[11] = organism, self.version_status, \
            self.assembly_level
        cols[12], cols[13], cols[15] = "Major", "Full", self.asm_name
        cols[19] = self.ftp_path if self.listed_path else "na"
        return "\t".join(cols) + "\n"


def local_path(root: str, url: str) -> str:
    """The file of the mirror at `root` that `url` names."""
    return os.path.join(root, urllib.parse.urlsplit(url).path.lstrip("/"))


def local_fetch(root: str):
    """A stand-in for install_db.fetch (same signature, same skip of an
    existing `dest`, same write through `dest`.part) that copies the
    mirror's file at the URL's path; a file the mirror lacks raises
    FileNotFoundError."""
    def fetch(url: str, dest: str) -> None:
        if os.path.exists(dest):
            return
        tmp = dest + ".part"
        shutil.copyfile(local_path(root, url), tmp)
        os.replace(tmp, dest)
    return fetch


def write_summary(root: str, group: str, rows: List[str]) -> str:
    path = local_path(root, f"{NCBI}/genomes/refseq/{group}/"
                            f"assembly_summary.txt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write("#   See ftp://ftp.ncbi.nlm.nih.gov/genomes/README_"
                 "assembly_summary.txt for a description of the columns\n")
        fh.write("# " + "\t".join(SUMMARY_HEADER) + "\n")
        fh.writelines(rows)
    return path


def write_taxonomy(root: str, taxa: Dict[int, Tuple[int, str, str]]) -> str:
    """pub/taxonomy/taxdump.tar.gz with names.dmp and nodes.dmp as
    top-level members."""
    path = local_path(root, f"{NCBI}/pub/taxonomy/taxdump.tar.gz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        names, nodes = (os.path.join(tmp, f) for f in ("names.dmp",
                                                       "nodes.dmp"))
        write_taxdump(names, nodes, taxa)
        with tarfile.open(path, "w:gz") as tf:
            tf.add(names, arcname="names.dmp")
            tf.add(nodes, arcname="nodes.dmp")
    return path


def write_assembly(root: str, asm: Assembly, taxa: Dict[int, tuple],
                   seed: int = 0) -> List[dict]:
    """The assembly's <name>_genomic.gbff.gz (spread_assembly's entries;
    gzip level 1, the fastest) under its ftp_path; returns the
    entries."""
    entries = spread_assembly(asm.g, asm.length, taxa, seed, asm.plasmid)
    path = local_path(root, asm.gbff_url)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    plain = path[:-len(".gz")]
    write_gbff(plain, entries)
    with open(plain, "rb") as src, \
            gzip.open(path, "wb", compresslevel=1) as out:
        shutil.copyfileobj(src, out, 1 << 22)
    os.remove(plain)
    return entries


def _write_assembly(args) -> List[dict]:
    return write_assembly(*args)


def write_mirror(root: str, assemblies: List[Assembly],
                 taxa: Dict[int, tuple], seed: int = 0,
                 map_fn=map) -> List[List[dict]]:
    """The whole tree: the taxdump, each group's assembly_summary.txt
    (rows in the order given) and every assembly's GBFF, written through
    `map_fn` (a process pool's map writes them in parallel).  Returns
    each assembly's entries, in order."""
    write_taxonomy(root, taxa)
    for group in dict.fromkeys(a.group for a in assemblies):
        write_summary(root, group, [a.summary_row(taxa[100 + a.g][2])
                                    for a in assemblies if a.group == group])
    return list(map_fn(_write_assembly, [(root, a, taxa, seed)
                                         for a in assemblies]))


def db_files(directory: str) -> Dict[str, object]:
    """What an install wrote under `directory`: relative path -> bytes,
    an .npz as the (name, bytes) of its members in order (np.savez
    stamps each member with the time it was written, so two builds of
    one DB differ there and nowhere else)."""
    out = {}
    for base, _, files in os.walk(directory):
        for f in files:
            path = os.path.join(base, f)
            if f.endswith(".npz"):
                with zipfile.ZipFile(path) as zf:
                    data = [(m, zf.read(m)) for m in zf.namelist()]
            else:
                with open(path, "rb") as fh:
                    data = fh.read()
            out[os.path.relpath(path, directory)] = data
    return out


# --- RefSeq-like bacterial assemblies ---

def spread_lengths(n: int) -> List[int]:
    """n chromosome lengths at the quantiles of a log-normal of median
    4 Mbp and sigma 0.5 (RefSeq's complete bacteria: ~4 Mbp, most within
    1-8 Mbp), clipped to 1-8 Mbp, ascending."""
    dist = statistics.NormalDist(np.log(4e6), 0.5)
    return [int(min(max(np.exp(dist.inv_cdf((i + 0.5) / n)), 1e6), 8e6))
            for i in range(n)]


def genus_taxa(n_genomes: int, n_genera: int) -> Dict[int, tuple]:
    """write_taxdump's taxa: Bacteria (2), genera 1000 + k, and species
    100 + g in genus 1000 + g % n_genera."""
    taxa = {2: (1, "superkingdom", "Bacteria")}
    for k in range(n_genera):
        taxa[1000 + k] = (2, "genus", f"Synthus{k}")
    for g in range(n_genomes):
        k = g % n_genera
        taxa[100 + g] = (1000 + k, "species",
                         f"Synthus{k} realisticus {g}")
    return taxa


def spread_assembly(g: int, length: int, taxa: Dict[int, tuple],
                    seed: int = 0, plasmid: bool = False) -> List[dict]:
    """write_gbff's dicts of genome g (taxid 100 + g, in the genus
    taxa names its parent): a chromosome of `length` bp built as
    eval/realistic builds one (piecewise GC; rRNA operons and IS elements
    from masters shared by the genomes of its genus, so that a read of a
    repeat has its genus for LCA; low-complexity tracts) and, with
    `plasmid`, the plasmid shared by every carrier of `seed` as a second
    entry, with ~0.86 genes a kbp (entries_to_gbff_dicts' gap parameter
    at 10: gaps of 30-200 bp between genes of 300-1800 bp)."""
    plasmid_master = realistic._segmented_background(
        np.random.default_rng(seed), 25_000)
    masters = np.random.default_rng([seed, taxa[100 + g][0]])
    rrna = realistic.BASES[masters.integers(0, 4, 5_000)]
    is_masters = [realistic.BASES[masters.integers(0, 4, 1_200)]
                  for _ in range(3)]
    rng = np.random.default_rng([seed, g])
    seq = realistic._segmented_background(rng, length)
    for _ in range(int(rng.integers(2, 8))):
        realistic._plant(seq, rng, realistic._mutated(
            rng, rrna, rng.uniform(0.005, 0.02)))
    for master in is_masters:
        for _ in range(int(rng.integers(5, 26))):
            realistic._plant(seq, rng, realistic._mutated(
                rng, master, rng.uniform(0.0, 0.08)))
    for _ in range(int(rng.integers(3, 9))):
        realistic._plant(seq, rng, realistic._low_complexity(
            rng, int(rng.integers(200, 2_000))))
    organism = taxa[100 + g][2]
    entries = [realistic.RealisticEntry(seq, 100 + g, f"RG{g:05d}.1",
                                        organism)]
    if plasmid:
        entries.append(realistic.RealisticEntry(
            realistic._mutated(rng, plasmid_master, 0.005), 100 + g,
            f"RP{g:05d}.1", organism, is_plasmid=True))
    dicts = realistic.entries_to_gbff_dicts(entries, 10.0,
                                            seed=seed * 100_003 + g)
    for i, (d, e) in enumerate(zip(dicts, entries)):
        d["gi"] = 1_000_000 + 10 * g + i
        d["definition"] = (f"{organism} plasmid p{g}, complete sequence"
                           if e.is_plasmid else
                           f"{organism} chromosome, complete genome")
    return dicts
