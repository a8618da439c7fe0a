"""The host-object path (--device-pipeline off: exact join and
flat-window SW on the device, host pairing, screens and pseudo-assembly)
of kslam_tpu_torch.cli --device cpu against kslam_tpu.cli
--device-pipeline off: the SAM without @PG, the XML, _PerRead and
_abbreviated files must be byte-identical."""

import pytest
import torch

from tests import torch_cli_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genbank(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_host_path")
    return root, fx.genbank_db(root)


@pytest.mark.parametrize("single", [False, True], ids=["paired", "single"])
def test_host_path_matches_jax(genbank, single):
    root, db = genbank
    name = "single" if single else "paired"
    t_files, j_files = fx.compare_files(root, db, name, [], single,
                                        pipeline="off")
    assert t_files == j_files
    assert t_files["_PerRead"] and "gene_GEN_A.1_" in t_files[""]
    assert sum(not line.startswith("@") for line in t_files["sam"]) >= 24
