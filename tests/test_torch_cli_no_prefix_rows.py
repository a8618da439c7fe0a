"""kslam_tpu_torch.cli --device cpu against kslam_tpu.cli on a
repeat-rich database, with the default join (the port's sector table,
the reference's bucket table, each with its tier 2) and with
--no-prefix-rows (the prefix window on pstart and its tier 2): the SAM
without @PG, the XML, _PerRead and _abbreviated files must be
byte-identical.  The port runs first: it builds its table at load and
leaves the DB directory as it was; the reference caches its bucket
table there."""

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
    before = sorted(os.listdir(db))
    mode = flags + ["--device-pipeline", "on"]
    t_files = fx.run_files(fx.tcli.main, root, db, f"{name}_torch",
                           mode + ["--device", "cpu"], False)
    # the port's run reads and writes no table cache in the DB directory
    assert sorted(os.listdir(db)) == before
    j_files = fx.run_files(fx.jcli.main, root, db, f"{name}_jax", mode,
                           False)
    assert t_files == j_files
    assert t_files["_PerRead"]
    assert sum(not line.startswith("@") for line in t_files["sam"]) >= 40
    # --no-prefix-rows (run first) builds no bucket table; the
    # reference's default run caches one
    assert os.path.exists(db / "bucket_table.npy") == (not flags)
