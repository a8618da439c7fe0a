"""Guards of the kslam_tpu_torch port: it imports where JAX is absent,
its copies of the reference package's host modules have not drifted,
its CLI refuses (never ignores) flags of paths not ported yet, and its
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
    assert "kslam_tpu_torch.ops.sw_cuda" in mods and len(mods) >= 20
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
#  the port leaves out, compare only these names (None: all))
COPIES = [
    ("config", "config", (), (), None),
    ("utils/logging", "utils/logging", (), (), None),
    ("utils/metrics", "utils/metrics", (), ("profile_to",), None),
    ("db/genbank", "db/genbank", (), (), None),
    ("db/taxonomy", "db/taxonomy", (), (), None),
    ("db/kmer_index", "db/kmer_index", (),
     ("KmerIndex.prefix_table", "KmerIndex.bucket_table",
      "KmerIndex._fingerprint", "KmerIndex.device_arrays",
      "KmerIndex.shard_bounds", "KmerIndex.shard"), None),
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
    ("pipeline/pairing", "pipeline/pairing", (), (), None),
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
    ("cli", "cli", (), (), ("build_database", "STREAM_BUILD_BP")),
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
    theirs = _items(os.path.join(ROOT, "kslam_tpu", ref + ".py"))
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


UNPORTED = [["--mesh", "2x4"], ["--shard-genomes"], ["--coordinator", "h:1"]]


@pytest.mark.parametrize("flags", UNPORTED, ids=[f[0] for f in UNPORTED])
def test_cli_refuses_unported_flags(flags, tmp_path):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        cli.main(["--db", str(tmp_path), "--device", "cpu", *flags,
                  str(tmp_path / "r1.fq")])


def test_cli_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--db", str(tmp_path), "--output-file",
                  str(tmp_path / "o"), str(tmp_path / "r1.fq")])


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
    """A tensor on neither the CPU nor a CUDA device is refused; the
    wrapper has no path that swaps in the twin for a device tensor."""
    from kslam_tpu_torch.ops import sw_cuda
    q = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no SW kernel"):
        sw_cuda.sw_forward_batch(q, q, 2, 3, 5, 2)
