"""Guards of the kslam_tpu_torch port: it imports where JAX is absent,
its copies of the reference package's host modules (and of
scripts/install_db.py and golden_ref/parity.py's writers) have not
drifted,
its CLI fails on a malformed --mesh as the reference's does, and its
native-library loader says why it did not build."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import kslam_tpu_torch
from kslam_tpu_torch import cli

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        kslam_tpu_torch.__path__, prefix="kslam_tpu_torch."))


def test_port_imports_without_jax():
    """Every port module imports in a process where `import jax` and
    `import kslam_tpu` fail."""
    mods = _port_modules()
    assert {"kslam_tpu_torch.ops.sw_cuda", "kslam_tpu_torch.ops.join",
            "kslam_tpu_torch.install_db", "kslam_tpu_torch.db.gbff",
            "kslam_tpu_torch.eval.ncbi_mirror"} <= set(mods) \
        and len(mods) >= 20
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['kslam_tpu'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kslam_tpu') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


# (port module, reference module, names that differ on purpose, names
#  the port leaves out, compare only these names (None: all)); a
#  reference module is one of kslam_tpu/, or a file from the repo's root
#  where it starts with "/"
COPIES = [
    ("config", "config", (), (), None),
    ("utils/logging", "utils/logging", (), (), None),
    # the port's stage timers also keep spans and take a lock
    ("utils/metrics", "utils/metrics", ("reset", "count", "stage",
                                        "summary"),
     ("profile_to", "gcups"),
     ("StageStats", "_STAGES", "_COUNTERS", "reset", "count", "stage",
      "summary", "log_summary", "profile_to", "gcups")),
    ("db/genbank", "db/genbank", (), (), None),
    ("db/taxonomy", "db/taxonomy", (), (), None),
    ("db/kmer_index", "db/kmer_index", ("index_words_np", "join_columns"),
     ("KmerIndex.device_arrays",), None),
    ("io/fastq", "io/fastq", (), (), None),
    ("io/native", "io/native",
     ("get_lib", "_BUILD_DIR", "BUILD_REPORT", "host_compilers",
      "build_host_library"), ("_LIB_PATH",), None),
    ("io/sam", "io/sam", (), (), None),
    ("golden/ssw", "golden/ssw", (), (), None),
    ("db/host_table", "db/host_table", (), (), None),
    ("pipeline/checkpoint", "pipeline/checkpoint", (), (), None),
    ("pipeline/align", "pipeline/align", (), (),
     ("_next_pow2", "compute_cigars_batch", "compute_overlap_cigar")),
    ("pipeline/run", "pipeline/run", (), (),
     ("process_batch", "_fill_cigars")),
    ("io/xml_results", "io/xml_results", (), (), None),
    # the insert model sorts and sums an int64 array, no int per size
    ("pipeline/pairing", "pipeline/pairing",
     ("max_allowed_insert_size_from_sizes",), (), None),
    ("pipeline/classify", "pipeline/classify", ("fetch_classify_arrays",),
     (), None),
    ("ops/encode", "ops/encode", (), (),
     ("kmer_codes_np", "sw_codes_np", "is_acgt_np", "complement_sw_codes_np",
      "decode_np", "encode_seq", "pack_reads_np", "reverse_complement_str",
      "_KMER_TABLE", "_ACGT_TABLE", "_SW_TABLE", "_CODE_TO_BASE")),
    ("ops/kmers", "ops/kmers", (), (),
     ("_revcomp_u64", "sequence_kmers_np", "kmer_string")),
    ("pipeline/device_path", "pipeline/device_path", (), (),
     ("rescore_sorted_host",)),
    # build_database parses GBFF with the linear-time db/gbff.py
    ("cli", "cli", ("build_database",), (),
     ("build_database", "STREAM_BUILD_BP")),
    ("parallel/dist", "parallel/dist", (), (),
     ("shard_database", "shard_genomes")),
    ("parallel/multihost", "parallel/multihost", (), (),
     ("strided_chunks", "concat_sam_parts")),
    ("eval/realistic", "eval/realistic", (), (), None),
    ("eval/comparison", "eval/comparison", (), (), None),
    ("golden/overlaps", "golden/overlaps", (), (), None),
    # build_database builds with kslam_tpu_torch.cli
    ("install_db", "/scripts/install_db", ("build_database",), (), None),
    ("eval/ncbi_mirror", "/golden_ref/parity", (), (),
     ("_GBFF_TEMPLATE", "_GENE_TEMPLATE", "_origin_block", "write_gbff",
      "write_taxdump")),
]


def _items(path):
    """name -> ast dump of top-level functions, classes' methods and
    assignments (imports and the module docstring excluded; comments
    are not in the tree)."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node) if isinstance(
                node, ast.FunctionDef) else None
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        out[f"{node.name}.{sub.name}"] = ast.dump(sub)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = ast.dump(node)
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            out[node.target.id] = ast.dump(node)
    return out


@pytest.mark.parametrize("port,ref,changed,dropped,only", COPIES,
                         ids=[c[0] for c in COPIES])
def test_copied_host_code_has_not_drifted(port, ref, changed, dropped,
                                          only):
    mine = _items(os.path.join(ROOT, "kslam_tpu_torch", port + ".py"))
    theirs = _items(ROOT + ref + ".py" if ref.startswith("/") else
                    os.path.join(ROOT, "kslam_tpu", ref + ".py"))
    names = only if only is not None else sorted(set(mine) | set(theirs))
    for name in names:
        if name in changed:
            assert name in mine and mine[name] != theirs.get(name), name
            continue
        if name in dropped:
            assert name not in mine, name
            continue
        assert name in mine and name in theirs, name
        assert mine[name] == theirs[name], f"{port}: {name} drifted"


MALFORMED_MESH = ["2by4", "2x", "2x2x2"]


@pytest.fixture(scope="module")
def tiny_db(tmp_path_factory):
    """A one-genome FASTA DB with a taxonomy and one read, built by the
    port's CLI."""
    root = tmp_path_factory.mktemp("guard_db")
    (root / "db.fa").write_text(">G0\n" + "ACGTTGCA" * 40 + "\n")
    (root / "names.dmp").write_text("1\t|\troot\t|\t\t|\tscientific name\t|\n")
    (root / "nodes.dmp").write_text("1\t|\t1\t|\tno rank\t|\n")
    db = root / "DB"
    assert cli.main(["--parse-fasta", "--output-file", str(db),
                     str(root / "db.fa")]) == 0
    assert cli.main(["--parse-taxonomy", str(root / "names.dmp"),
                     str(root / "nodes.dmp"), "--output-file",
                     str(db / "taxDB")]) == 0
    (root / "r1.fq").write_text("@q\n" + "ACGTTGCA" * 12 + "\n+\n"
                                + "I" * 96 + "\n")
    return root, db


@pytest.mark.parametrize("mesh", MALFORMED_MESH)
def test_cli_malformed_mesh_fails_as_reference(tiny_db, mesh):
    """A malformed --mesh raises the reference CLI's error (the same
    parse of the same string) after the DB has loaded."""
    from kslam_tpu import cli as jcli
    root, db = tiny_db
    errors = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (jcli.main, [])):
        with pytest.raises(ValueError) as err:
            main(["--db", str(db), "--output-file", str(root / "o"),
                  "--mesh", mesh, *extra, str(root / "r1.fq")])
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("flags", [[], ["--mesh", "2x2"],
                                   ["--coordinator", "localhost:1"]],
                         ids=["one_device", "mesh", "coordinator"])
def test_cli_cuda_without_card_raises(tmp_path, flags):
    """--device cuda (the default) never falls back to the CPU, on one
    device, on a mesh or over processes."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--db", str(tmp_path), "--output-file",
                  str(tmp_path / "o"), *flags, str(tmp_path / "r1.fq")])


def test_native_loader_reports_why_it_did_not_build(tmp_path,
                                                    monkeypatch):
    """A compiler that does not exist builds nothing, and the report
    names it with make's reason; the loader's own build either loaded
    the library or says why not."""
    from kslam_tpu_torch.io import native
    path, report = native.build_host_library(
        str(tmp_path / "build"), ["/nonexistent/bin/g++"])
    assert path is None
    assert "/nonexistent/bin/g++" in report and "No such file" in report
    assert not os.path.exists(tmp_path / "build" / "libkslam_host.so")
    lib = native.get_lib()
    assert native.BUILD_REPORT.startswith(
        "built with " if lib is not None else "no compiler built it")
    monkeypatch.setenv("CXX", "/opt/x/g++")
    assert native.host_compilers() == ["/opt/x/g++", "g++", "c++"]
    monkeypatch.delenv("CXX")
    assert native.host_compilers() == ["g++", "c++"]


def test_kernel_wrapper_never_falls_back():
    """A tensor on neither the CPU nor a CUDA device is refused by the
    SW and join wrappers; they have no path that swaps in the plain
    version for a device tensor."""
    from kslam_tpu_torch.ops import sw_cuda
    q = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no SW kernel"):
        sw_cuda.sw_forward_batch(q, q, 2, 3, 5, 2)
    with pytest.raises(ValueError, match="no SW kernel"):
        sw_cuda.sw_align_batch(q, q, 2, 3, 5, 2)
    from kslam_tpu_torch.ops import join
    keys = torch.zeros(64, dtype=torch.int64, device="meta")
    tbl = torch.zeros((1 << 4, 16), dtype=torch.int32, device="meta")
    pstart = torch.zeros(17, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no join kernel"):
        join.lookup_bucket(tbl, keys, 4)
    with pytest.raises(ValueError, match="no join kernel"):
        join.lookup_prefix_window(keys, pstart, keys, 4, 16)
