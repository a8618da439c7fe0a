"""Shared fixtures of the CLI comparisons between kslam_tpu_torch.cli
(--device cpu) and kslam_tpu.cli (the same --device-pipeline on both
sides: the reference's "auto" takes the host-object path off a TPU): two
databases and paired FASTQ, made from numpy seeds."""

import os

import numpy as np

from kslam_tpu import cli as jcli
from kslam_tpu.db.genbank import Gene, index_from_fasta
from kslam_tpu.db.kmer_index import KmerIndex
from kslam_tpu.db.taxonomy import TaxonomyDB
from kslam_tpu.ops.encode import reverse_complement_str
from kslam_tpu_torch import cli as tcli

B4 = np.frombuffer(b"ACGT", dtype=np.uint8)

# variant: (extra CLI flags, single-end).  Each test file runs one group
# of two, so that no file compiles more than a few JAX program sets.
VARIANTS = {
    "paired": ([], False),
    "single_end": ([], True),
    "no_pseudo_assembly": (["--no-pseudo-assembly"], False),
    "multi_chunk": (["--num-reads-at-once", "6"], False),
}
BASIC = ["paired", "single_end"]
OPTIONS = ["no_pseudo_assembly", "multi_chunk"]


def fasta_db(root):
    """FASTA DB built by the CLI (taxid 0 entries), as
    tests/test_device_path.py::test_cli_device_vs_host_pipeline."""
    rng = np.random.default_rng(77)
    genomes = {f"G{i}": B4[rng.integers(0, 4, 600)].tobytes().decode()
               for i in range(3)}
    fa = root / "db.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in genomes.items()))
    (root / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "2\t|\tBacteria\t|\t\t|\tscientific name\t|\n")
    (root / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tsuperkingdom\t|\n")
    db = root / "DB"
    jcli.main(["--parse-fasta", "--output-file", str(db), str(fa)])
    jcli.main(["--parse-taxonomy", str(root / "names.dmp"),
               str(root / "nodes.dmp"), "--output-file", str(db / "taxDB")])
    _reads(root, list(genomes.values()), rng, 18, 140, 160, 300)
    return db


def realistic_db(root):
    """Repeat-rich FASTA DB (kslam_tpu.eval.realistic: shared operons, IS
    copies and low-complexity tracts make prefix runs longer than the
    join's window and escaped buckets), built by the CLI, with paired
    reads drawn from it."""
    from kslam_tpu.eval import realistic
    entries = realistic.make_realistic_entries(n_genomes=2, bp_each=30_000,
                                               seed=7, plasmid_bp=6_000)
    seqs = [e.seq.tobytes().decode() for e in entries]
    fa = root / "db.fasta"
    fa.write_text("".join(f">R{i}\n{s}\n" for i, s in enumerate(seqs)))
    (root / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n")
    (root / "nodes.dmp").write_text("1\t|\t1\t|\tno rank\t|\n")
    db = root / "DB"
    jcli.main(["--parse-fasta", "--output-file", str(db), str(fa)])
    jcli.main(["--parse-taxonomy", str(root / "names.dmp"),
               str(root / "nodes.dmp"), "--output-file", str(db / "taxDB")])
    _reads(root, seqs, np.random.default_rng(9), 40, 150, 280, 420)
    return db


def genbank_db(root):
    """DB with taxids and gene annotation on every entry, as
    tests/test_end_to_end.py's dataset."""
    rng = np.random.default_rng(7)
    b = B4[rng.integers(0, 4, 1800)]
    # GEN_C shares 1200 bases with GEN_B: pairs there hit both entries
    # and classify to their genus
    genomes = {"GEN_A.1": (562, B4[rng.integers(0, 4, 2000)]),
               "GEN_B.1": (1280, b),
               "GEN_C.1": (1281, np.concatenate(
                   [b[:1200], B4[rng.integers(0, 4, 300)]]))}
    fasta = root / "db.fa"
    with open(fasta, "w") as fh:
        for name, (_, s) in genomes.items():
            fh.write(f">{name}\n{s.tobytes().decode()}\n")
    db = root / "DB"
    index = index_from_fasta([str(fasta)])
    for e in index.entries:
        e.taxonomy_id = genomes[e.locus_tag][0]
        n = len(e.bases)
        e.genes = [Gene(gene_name=f"gene_{e.locus_tag}_{k}",
                        protein_id=f"P_{e.locus_tag}_{k}",
                        product="synthetic", reference_sequence=e.locus_tag,
                        cds_start=k * n // 3, cds_stop=(k + 1) * n // 3)
                   for k in range(3)]
    index.save(str(db))
    KmerIndex.build(index).save(str(db))
    tax = TaxonomyDB()
    for t, (p, r, n) in {
            1: (1, "no rank", "root"),
            2: (1, "superkingdom", "Bacteria"),
            1279: (2, "genus", "Staphylococcus"),
            562: (2, "species", "Escherichia coli"),
            1280: (1279, "species", "Staphylococcus aureus"),
            1281: (1279, "species", "Staphylococcus carnosus")}.items():
        tax.parent_of[t] = p
        tax.rank_of[t] = r
        tax.name_of[t] = n
    tax.write_index(str(db / "taxDB"))
    seqs = [s.tobytes().decode() for _, s in genomes.values()]
    _reads(root, seqs, rng, 24, 150, 280, 420)
    return db


def _reads(root, seqs, rng, n_pairs, read_len, ins_lo, ins_hi):
    with open(root / "r1.fq", "w") as f1, open(root / "r2.fq", "w") as f2:
        for i in range(n_pairs):
            g = seqs[i % len(seqs)]
            pos = int(rng.integers(0, len(g) - ins_hi - 1))
            ins = int(rng.integers(ins_lo, ins_hi))
            fwd = list(g[pos:pos + read_len])
            fwd[int(rng.integers(0, read_len))] = \
                chr(int(rng.choice(B4)))
            rev = g[pos + ins - read_len:pos + ins]
            f1.write(f"@rd{i}/1\n{''.join(fwd)}\n+\n{'I' * read_len}\n")
            f2.write(f"@rd{i}/2\n{reverse_complement_str(rev)}\n+\n"
                     f"{'I' * read_len}\n")


SUFFIXES = ("", "_PerRead", "_abbreviated")


def compare(root, db, variant):
    """Run both CLIs on one variant; returns (torch files, jax files) as
    lists of the XML, _PerRead and _abbreviated texts."""
    flags, single = VARIANTS[variant]
    t_files, j_files = compare_files(root, db, variant, flags, single,
                                     sam=False)
    return [t_files[s] for s in SUFFIXES], [j_files[s] for s in SUFFIXES]


def run_files(main, root, db, name, flags, single, sam=True):
    """One CLI run; returns {suffix: text} of the outputs it wrote, with
    the SAM (key "sam") as its lines without @PG (the command line)."""
    reads = [str(root / "r1.fq")] + ([] if single else [str(root / "r2.fq")])
    out = str(root / f"out_{name}")
    args = ["--db", str(db), "--output-file", out] + flags + reads
    if sam:
        args += ["--sam-file", out + ".sam"]
    assert main(args) == 0
    files = {}
    if sam:
        with open(out + ".sam") as fh:
            files["sam"] = [line for line in fh if not line.startswith("@PG")]
    for suf in SUFFIXES:
        if os.path.exists(out + suf):
            with open(out + suf) as fh:
                files[suf] = fh.read()
    return files


def compare_files(root, db, name, flags, single, pipeline="on", sam=True):
    """Both CLIs with `flags` and --device-pipeline `pipeline`; returns
    (torch files, jax files) of run_files."""
    mode = ["--device-pipeline", pipeline]
    return (run_files(tcli.main, root, db, f"{name}_torch",
                      flags + mode + ["--device", "cpu"], single, sam),
            run_files(jcli.main, root, db, f"{name}_jax", flags + mode,
                      single, sam))
