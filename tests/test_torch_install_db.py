"""kslam_tpu_torch.install_db against scripts/install_db.py (which builds
with kslam_tpu.cli), offline: both fetch from one local mirror written by
kslam_tpu_torch.eval.ncbi_mirror (its `local_fetch` patched in as each
module's `fetch`), and must fetch the same files in the same order and
write the same DB: every file byte for byte, an .npz member by member
(np.savez stamps each member with the time it was written)."""

import gzip
import os
import sys
import tarfile

import pytest
import torch

from kslam_tpu import cli as jcli
from kslam_tpu_torch import cli as tcli
from kslam_tpu_torch import install_db
from kslam_tpu_torch.eval import ncbi_mirror as nm
from tests.test_install_db import NAMES_DMP, NODES_DMP
from tests.test_io import GBFF

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
import install_db as ref_install_db  # noqa: E402

torch.set_num_threads(1)

INSTALLERS = {"port": install_db, "reference": ref_install_db}

# five complete, latest bacteria (one with the shared plasmid); three rows
# that download_genomes skips although their files are in the mirror; two
# viral assemblies, one of them not complete (only bacteria must be)
ASSEMBLIES = [nm.Assembly(g, 14_000 + 3_000 * g, plasmid=g % 3 == 0)
              for g in range(5)] + [
    nm.Assembly(5, 9_000, version_status="replaced"),
    nm.Assembly(6, 9_000, assembly_level="Scaffold"),
    nm.Assembly(7, 9_000, listed_path=False),
    nm.Assembly(8, 8_000, group="viral"),
    nm.Assembly(9, 7_000, group="viral", assembly_level="Contig")]


@pytest.fixture(scope="module")
def mirror(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ncbi_mirror"))
    nm.write_mirror(root, ASSEMBLIES, nm.genus_taxa(10, 3), seed=4)
    return root


def _install(mirror, tmp_path, which, flags, fail=()):
    """`main` of one installer with fetch bound to the mirror; the URLs in
    `fail` raise.  Returns (DB dir, fetched URLs in order)."""
    mod = INSTALLERS[which]
    fetched = []
    local = nm.local_fetch(mirror)

    def fetch(url, dest):
        fetched.append(url)
        if url in fail:
            raise OSError(f"simulated failure of {url}")
        local(url, dest)
    db = str(tmp_path / f"DB_{which}")
    real = mod.fetch
    mod.fetch = fetch
    try:
        assert mod.main(["--db", db, "--work", str(tmp_path / f"W_{which}"),
                         *flags]) == 0
    finally:
        mod.fetch = real
    return db, fetched


MAIN_CASES = {
    "bacteria": (["--bacteria"], ()),
    "bacteria_viruses": (["--bacteria", "--viruses"], ()),
    "max_assemblies": (["--bacteria", "--viruses", "--max-assemblies", "2"],
                       ()),
    "failed_fetch": (["--bacteria", "--viruses"], (ASSEMBLIES[1].gbff_url,)),
}


@pytest.mark.parametrize("case", sorted(MAIN_CASES))
def test_main_same_fetches_and_db(mirror, tmp_path, capsys, case):
    flags, fail = MAIN_CASES[case]
    port_db, port_fetched = _install(mirror, tmp_path, "port", flags, fail)
    port_log = capsys.readouterr().out
    ref_db, ref_fetched = _install(mirror, tmp_path, "reference", flags, fail)
    ref_log = capsys.readouterr().out
    assert port_fetched == ref_fetched
    assert nm.db_files(port_db) == nm.db_files(ref_db)
    # the complete, latest assemblies of each group, in the summary's
    # order, up to --max-assemblies of each
    cap = 2 if case == "max_assemblies" else None
    groups = ["bacteria"] + (["viral"] if "--viruses" in flags else [])
    want = [a.gbff_url for group in groups
            for a in [a for a in ASSEMBLIES
                      if a.installed and a.group == group][:cap]]
    assert [u for u in port_fetched if u.endswith(".gbff.gz")] == want
    if fail:
        assert f"failed {fail[0]}" in port_log and \
            f"failed {fail[0]}" in ref_log
    files = nm.db_files(port_db)
    assert {"taxDB", "meta.json", "genomes.npz", "kmer_index.npz"} <= \
        set(files)


def test_resume_fetches_nothing(mirror, tmp_path):
    """A second install over the same work directory fetches nothing (the
    markers) and writes the same DB; it equals the reference's."""
    flags = ["--bacteria", "--viruses"]
    db, first = _install(mirror, tmp_path, "port", flags)
    before = nm.db_files(db)
    _, second = _install(mirror, tmp_path, "port", flags)
    # the taxdump, then each group's summary and assemblies
    assert len(first) == 1 + (1 + 5) + (1 + 2) and second == []
    assert nm.db_files(db) == before
    ref_db, _ = _install(mirror, tmp_path, "reference", flags)
    assert nm.db_files(ref_db) == before


def _gbff_dirs(mirror, tmp_path):
    """Two genome directories as download_genomes leaves them: the
    installed bacteria in two GBFF files, and tests/test_io.py's GBFF."""
    a = tmp_path / "bacteria"
    b = tmp_path / "other"
    a.mkdir()
    b.mkdir()
    asms = [x for x in ASSEMBLIES if x.installed and x.group == "bacteria"]
    for i, part in enumerate((asms[:2], asms[2:])):
        with open(a / f"part{i}.gbff", "wb") as out:
            for asm in part:
                with gzip.open(nm.local_path(mirror, asm.gbff_url)) as fh:
                    out.write(fh.read())
    (b / "a.gbff").write_text(GBFF)
    tax = tmp_path / "taxonomy"
    tax.mkdir()
    (tax / "names.dmp").write_text(NAMES_DMP)
    (tax / "nodes.dmp").write_text(NODES_DMP)
    return str(tax), [str(a), str(b)]


@pytest.mark.parametrize("stream", [False, True], ids=["in_ram", "streamed"])
def test_build_database_identical(mirror, tmp_path, monkeypatch, stream):
    """build_database on GBFF files with genes: the whole DB directory
    equals the reference's, also through the out-of-core index build
    (STREAM_BUILD_BP patched low in both CLIs)."""
    if stream:
        monkeypatch.setattr(tcli, "STREAM_BUILD_BP", 1000)
        monkeypatch.setattr(jcli, "STREAM_BUILD_BP", 1000)
    tax, dirs = _gbff_dirs(mirror, tmp_path)
    dbs = {}
    for which, mod in INSTALLERS.items():
        dbs[which] = str(tmp_path / f"DB_{which}")
        mod.build_database(dbs[which], tax, dirs)
    files = nm.db_files(dbs["port"])
    assert files == nm.db_files(dbs["reference"])
    index_files = {"kmers.npy", "entry_id.npy", "offset.npy", "rc.npy"}
    assert (index_files <= set(files)) == stream
    assert ("kmer_index.npz" in files) != stream
    meta = files["meta.json"]
    assert b"thrA" in meta and b"chromosome, complete genome" in meta


PARSE_CASES = ["fasta", "taxonomy", "genbank"]


@pytest.mark.parametrize("kind", PARSE_CASES)
def test_parse_flags_identical(mirror, tmp_path, kind):
    """--parse-fasta, --parse-taxonomy and --parse-genbank of both CLIs
    write the same files."""
    src = tmp_path / "src"
    src.mkdir()
    if kind == "fasta":
        (src / "a.fa").write_text(">A one\nACGTTGCAAC" * 30 + "\n>B\n"
                                  + "GATTACA" * 50 + "\n")
        (src / "b.fa").write_text(">C two words\n" + "CCGGAATT" * 40 + "\n")
        args = ["--parse-fasta", str(src / "a.fa"), str(src / "b.fa")]
    elif kind == "taxonomy":
        nm.write_taxdump(str(src / "names.dmp"), str(src / "nodes.dmp"),
                         nm.genus_taxa(6, 2))
        args = ["--parse-taxonomy", str(src / "names.dmp"),
                str(src / "nodes.dmp")]
    else:
        paths = []
        for asm in ASSEMBLIES[:3]:
            path = src / f"{asm.accession}.gbff"
            with gzip.open(nm.local_path(mirror, asm.gbff_url)) as fh:
                path.write_bytes(fh.read())
            paths.append(str(path))
        args = ["--parse-genbank", *paths]
    outs = {}
    for name, main in (("port", tcli.main), ("reference", jcli.main)):
        out = tmp_path / name
        target = out / "taxDB" if kind == "taxonomy" else out
        assert main(args + ["--output-file", str(target)]) == 0
        outs[name] = nm.db_files(str(out))
    assert outs["port"] == outs["reference"] and outs["port"]


def test_markers(tmp_path):
    m = tmp_path / "marker"
    assert not install_db.marker(str(m))
    install_db.touch(str(m))
    assert install_db.marker(str(m))


def test_local_fetch_reads_the_mirror(mirror, tmp_path):
    """local_fetch copies the file the URL's path names, leaves an
    existing destination alone, and raises for a file the mirror lacks;
    the mirror's taxdump has names.dmp and nodes.dmp at its top level."""
    fetch = nm.local_fetch(mirror)
    dest = str(tmp_path / "taxdump.tar.gz")
    fetch(f"{nm.NCBI}/pub/taxonomy/taxdump.tar.gz", dest)
    with tarfile.open(dest) as tf:
        assert sorted(tf.getnames()) == ["names.dmp", "nodes.dmp"]
    with open(dest, "wb") as fh:
        fh.write(b"kept")
    fetch(f"{nm.NCBI}/pub/taxonomy/taxdump.tar.gz", dest)
    assert open(dest, "rb").read() == b"kept"
    with pytest.raises(FileNotFoundError):
        fetch(f"{nm.NCBI}/genomes/refseq/archaea/assembly_summary.txt",
              str(tmp_path / "s.txt"))
    rows = [line.split("\t") for line in open(nm.local_path(
        mirror, f"{nm.NCBI}/genomes/refseq/bacteria/assembly_summary.txt"))
        if not line.startswith("#")]
    assert len(rows) == 8 and all(len(r) >= 20 for r in rows)
    assert [r[10] for r in rows].count("latest") == 7
    assert sum(not r[19].startswith("http") for r in rows) == 1
