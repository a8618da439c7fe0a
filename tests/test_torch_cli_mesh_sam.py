"""kslam_tpu_torch.cli --device cpu --mesh 2x2 --sam-file against
kslam_tpu.cli with the same flags (the 8-virtual-device CPU mesh of
tests/conftest.py): the SAM without its @PG line (the command line), the
XML, _PerRead and _abbreviated files must be byte-identical.  The port's
mesh cells all live on the CPU."""

import pytest
import torch

from tests import torch_cli_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genbank(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_mesh_sam_genbank")
    return root, fx.genbank_db(root)


def test_mesh_sam_cli_equals_jax(genbank):
    root, db = genbank
    t_files, j_files = fx.compare_files(root, db, "mesh_2x2_sam",
                                        ["--mesh", "2x2"], single=False)
    assert t_files == j_files
    assert "gene_GEN_A.1_" in t_files[""]
    body = [line for line in t_files["sam"] if not line.startswith("@")]
    assert len(body) >= 24
