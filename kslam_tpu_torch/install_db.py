"""Database provisioning of the PyTorch/CUDA port: download NCBI data
and build the DB with kslam_tpu_torch.cli.

The port's counterpart of scripts/install_db.py (which builds with
kslam_tpu.cli, and so needs JAX): fetches the NCBI taxonomy dump and
RefSeq bacteria/virus genomes (assembly_summary.txt-driven: complete
genomes at the latest version), with marker-file download resume, then
builds:

  <db>/taxDB            flat taxonomy index      (--parse-taxonomy)
  <db>/genomes.npz etc  genome + gene tables     (--parse-genbank)
  <db>/kmer_index.npz   presorted k-mer shards

Usage:
  python -m kslam_tpu_torch.install_db --db DB_DIR [--bacteria] [--viruses]
      [--work DIR] [--mirror https://ftp.ncbi.nlm.nih.gov]
      [--max-assemblies N]

All network access is plain HTTPS via urllib; every step is skipped when
its marker file exists, so interrupted installs resume.  The files are
the reference script's, byte for byte (the npz containers member by
member).  tests/test_torch_port_guard.py holds every definition but
build_database equal to the script's.
"""

from __future__ import annotations

import argparse
import gzip
import os
import shutil
import sys
import tarfile
import urllib.request

NCBI = "https://ftp.ncbi.nlm.nih.gov"


def log(msg: str) -> None:
    print(msg, flush=True)


def fetch(url: str, dest: str) -> None:
    if os.path.exists(dest):
        return
    log(f"Downloading {url}")
    tmp = dest + ".part"
    with urllib.request.urlopen(url) as r, open(tmp, "wb") as out:
        shutil.copyfileobj(r, out)
    os.replace(tmp, dest)


def marker(path: str) -> bool:
    return os.path.exists(path)


def touch(path: str) -> None:
    open(path, "w").close()


def download_taxonomy(work: str, mirror: str) -> str:
    tdir = os.path.join(work, "taxonomy")
    os.makedirs(tdir, exist_ok=True)
    done = os.path.join(tdir, "taxdownloaded")
    if not marker(done):
        tar = os.path.join(tdir, "taxdump.tar.gz")
        fetch(f"{mirror}/pub/taxonomy/taxdump.tar.gz", tar)
        log("Decompressing taxonomy")
        with tarfile.open(tar) as tf:
            tf.extract("names.dmp", tdir)
            tf.extract("nodes.dmp", tdir)
        touch(done)
    else:
        log("Already downloaded taxonomy")
    return tdir


def download_genomes(work: str, group: str, mirror: str,
                     max_assemblies: int = 0) -> str:
    """RefSeq GBFF files for `group` ("bacteria" or "viral"), driven by
    assembly_summary.txt (install_slam_new_db.sh:40-96): complete genomes
    at the latest version."""
    gdir = os.path.join(work, group)
    os.makedirs(gdir, exist_ok=True)
    done = os.path.join(gdir, f"{group}librarydownloaded")
    if marker(done):
        log(f"Already downloaded {group} genomes")
        return gdir
    summary = os.path.join(gdir, "assembly_summary.txt")
    fetch(f"{mirror}/genomes/refseq/{group}/assembly_summary.txt", summary)
    n = 0
    with open(summary) as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 20:
                continue
            version_status, assembly_level, ftp_path = \
                cols[10], cols[11], cols[19]
            if version_status != "latest" or not ftp_path.startswith("http"):
                continue
            if group == "bacteria" and assembly_level != "Complete Genome":
                continue
            name = ftp_path.rsplit("/", 1)[-1]
            url = f"{ftp_path}/{name}_genomic.gbff.gz"
            dest_gz = os.path.join(gdir, f"{name}.gbff.gz")
            dest = os.path.join(gdir, f"{name}.gbff")
            if not os.path.exists(dest):
                try:
                    fetch(url, dest_gz)
                    with gzip.open(dest_gz, "rb") as zin, \
                            open(dest + ".part", "wb") as out:
                        shutil.copyfileobj(zin, out)
                    os.replace(dest + ".part", dest)
                    os.remove(dest_gz)
                except Exception as e:  # noqa: BLE001 - resumable fetch
                    log(f"failed {url}: {e}")
                    continue
            n += 1
            if max_assemblies and n >= max_assemblies:
                break
    log(f"Fetched {n} {group} assemblies")
    touch(done)
    return gdir


def build_database(db_dir: str, tax_dir: str, genome_dirs) -> None:
    from kslam_tpu_torch import cli
    os.makedirs(db_dir, exist_ok=True)
    log("Creating taxonomy database")
    cli.main(["--parse-taxonomy",
              os.path.join(tax_dir, "names.dmp"),
              os.path.join(tax_dir, "nodes.dmp"),
              "--output-file", os.path.join(db_dir, "taxDB")])
    gbffs = []
    for d in genome_dirs:
        gbffs.extend(os.path.join(d, f) for f in sorted(os.listdir(d))
                     if f.endswith(".gbff"))
    if not gbffs:
        log("No GBFF files found; skipping sequence database")
        return
    log(f"Creating sequence database from {len(gbffs)} GBFF files")
    cli.main(["--parse-genbank", *gbffs, "--output-file", db_dir])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--db", required=True, help="output database directory")
    ap.add_argument("--work", default="", help="download/work directory "
                    "(default: <db>/downloads)")
    ap.add_argument("--bacteria", action="store_true")
    ap.add_argument("--viruses", action="store_true")
    ap.add_argument("--mirror", default=NCBI)
    ap.add_argument("--max-assemblies", type=int, default=0,
                    help="cap assemblies per group (testing)")
    args = ap.parse_args(argv)
    if not (args.bacteria or args.viruses):
        ap.error("pick at least one of --bacteria / --viruses")
    work = args.work or os.path.join(args.db, "downloads")
    os.makedirs(work, exist_ok=True)
    tax_dir = download_taxonomy(work, args.mirror)
    genome_dirs = []
    if args.bacteria:
        genome_dirs.append(download_genomes(work, "bacteria", args.mirror,
                                            args.max_assemblies))
    if args.viruses:
        genome_dirs.append(download_genomes(work, "viral", args.mirror,
                                            args.max_assemblies))
    build_database(args.db, tax_dir, genome_dirs)
    log("Done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
