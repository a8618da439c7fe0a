"""--resume in kslam_tpu_torch.cli (tests/test_checkpoint.py's scenario):
a run that crashes in its third chunk, after two checkpointed chunks, and
is then resumed must write exactly what an uninterrupted port run writes,
and what kslam_tpu.cli writes on the same inputs (SAM without @PG).
Reads carry indels, so the SAM holds soft clips, I/D cigars and MD tags."""

import os

import numpy as np
import pytest
import torch

from kslam_tpu import cli as jcli
from kslam_tpu_torch import cli as tcli
from kslam_tpu_torch.pipeline import run as trun
from kslam_tpu_torch.pipeline.checkpoint import RunCheckpoint
from tests import torch_cli_fixtures as fx

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_resume")
    rng = np.random.default_rng(13)
    genomes = [fx.B4[rng.integers(0, 4, 700)].tobytes().decode()
               for _ in range(2)]
    (root / "db.fasta").write_text(
        "".join(f">G{i}\n{g}\n" for i, g in enumerate(genomes)))
    (root / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "2\t|\tBacteria\t|\t\t|\tscientific name\t|\n")
    (root / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tsuperkingdom\t|\n")
    db = root / "DB"
    jcli.main(["--parse-fasta", "--output-file", str(db),
               str(root / "db.fasta")])
    jcli.main(["--parse-taxonomy", str(root / "names.dmp"),
               str(root / "nodes.dmp"), "--output-file", str(db / "taxDB")])
    with open(root / "r1.fq", "w") as f1, open(root / "r2.fq", "w") as f2:
        for i in range(24):
            g = genomes[i % 2]
            pos = int(rng.integers(0, 700 - 330))
            r1 = g[pos:pos + 150]
            if i % 3 == 0:                     # a 2-base deletion
                r1 = r1[:60] + r1[62:] + g[pos + 150:pos + 152]
            elif i % 3 == 1:                   # a 1-base insertion
                r1 = r1[:90] + "A" + r1[90:149]
            r2 = fx.reverse_complement_str(g[pos + 180:pos + 330])
            f1.write(f"@q{i}/1\n{r1}\n+\n{'I' * 150}\n")
            f2.write(f"@q{i}/2\n{r2}\n+\n{'I' * 150}\n")
    return root, db


CASES = {
    # name: (flags, single-end, device pipeline, function to crash)
    "device_just_align": (["--just-align"], True, "on", "process_chunk"),
    "host_just_align": (["--just-align"], True, "off", "process_batch"),
    "device_classify": ([], False, "on", "process_chunk"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_resume_matches_uninterrupted_and_jax(dataset, case, monkeypatch):
    root, db = dataset
    flags, single, pipeline, crash_fn = CASES[case]
    flags = flags + ["--num-reads-at-once", "8", "--device-pipeline",
                     pipeline]
    full = fx.run_files(tcli.main, root, db, f"{case}_full",
                        flags + ["--device", "cpu"], single)
    ref = fx.run_files(jcli.main, root, db, f"{case}_jax", flags, single)
    assert full == ref
    assert any("I" in line.split("\t")[5] or "D" in line.split("\t")[5]
               for line in full["sam"] if not line.startswith("@"))

    real = getattr(trun, crash_fn)
    calls = {"n": 0}

    def crashing(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt("simulated crash")
        return real(*args, **kwargs)

    monkeypatch.setattr(trun, crash_fn, crashing)
    args = flags + ["--device", "cpu", "--resume"]
    with pytest.raises(KeyboardInterrupt):
        fx.run_files(tcli.main, root, db, f"{case}_part", args, single)
    ck = RunCheckpoint(str(root / f"out_{case}_part"))
    assert os.path.exists(ck.cursor_path)
    assert ck.load()[0] == 2                  # two chunks checkpointed
    monkeypatch.setattr(trun, crash_fn, real)
    part = fx.run_files(tcli.main, root, db, f"{case}_part", args, single)
    assert not os.path.exists(ck.cursor_path)  # cleared on completion
    assert part == full
