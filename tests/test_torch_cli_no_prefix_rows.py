"""kslam_tpu_torch.cli --device cpu against kslam_tpu.cli on a
repeat-rich database, with the default join (the bucket table and its
tier 2) and with --no-prefix-rows (the prefix window on pstart and its
tier 2): the SAM without @PG, the XML, _PerRead and _abbreviated files
must be byte-identical.  The port runs first and caches the bucket
table in the DB directory; the reference then reads that cache."""

import os

import pytest
import torch

from tests import torch_cli_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def realistic(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_no_prefix_rows")
    return root, fx.realistic_db(root)


@pytest.mark.parametrize("flags", [["--no-prefix-rows"], []],
                         ids=["no_prefix_rows", "bucket"])
def test_join_flags_match_jax(realistic, flags):
    root, db = realistic
    name = "window" if flags else "bucket"
    t_files, j_files = fx.compare_files(root, db, name, flags, False)
    assert t_files == j_files
    assert t_files["_PerRead"]
    assert sum(not line.startswith("@") for line in t_files["sam"]) >= 40
    # --no-prefix-rows (run first) builds no bucket table; the default
    # caches one
    assert os.path.exists(db / "bucket_table.npy") == (not flags)
