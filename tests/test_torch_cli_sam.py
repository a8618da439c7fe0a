"""kslam_tpu_torch.cli --device cpu against kslam_tpu.cli, both with
--device-pipeline on, with SAM output: the SAM (without the @PG line,
which carries the command line), the XML, _PerRead and _abbreviated
files must be byte-identical."""

import pytest
import torch

from tests import torch_cli_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genbank(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_sam_genbank")
    return root, fx.genbank_db(root)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_sam_fasta")
    return root, fx.fasta_db(root)


@pytest.mark.parametrize("name,flags", [
    ("paired", []),
    ("top1_xa", ["--num-alignments", "1", "--sam-xa"])])
def test_sam_paired_genbank(genbank, name, flags):
    root, db = genbank
    t_files, j_files = fx.compare_files(root, db, name, flags, single=False)
    assert t_files == j_files
    body = [line for line in t_files["sam"] if not line.startswith("@")]
    assert len(body) >= 24 and "gene_GEN_A.1_" in t_files[""]
    assert any("\tGEN_B.1\t" in line for line in body)


def test_just_align_single_end_fasta(fasta):
    root, db = fasta
    t_files, j_files = fx.compare_files(root, db, "just_align",
                                        ["--just-align"], single=True)
    assert t_files == j_files
    assert set(t_files) == {"sam"}          # no XML or TSV
    assert sum(not line.startswith("@") for line in t_files["sam"]) >= 18
