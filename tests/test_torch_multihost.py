"""Two kslam_tpu_torch processes (--device cpu, torch.distributed over
gloo, --coordinator on a port found free at run time) against one
kslam_tpu.cli process: --just-align --sam-file (SAM lines as a set, one
header) and columnar classification (XML, _PerRead, _abbreviated
byte-identical); and a peer that dies fails the other process.  Every
process is waited for with a timeout."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from kslam_tpu import cli as jcli

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """As tests/test_multihost.py: a 3-genome FASTA DB with a one-node
    taxonomy and 24 single-end reads."""
    tmp = tmp_path_factory.mktemp("torch_mh")
    rng = np.random.default_rng(17)
    genomes = {f"G{i}": "".join(rng.choice(list("ACGT"), 500))
               for i in range(3)}
    fa = tmp / "db.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in genomes.items()))
    with open(tmp / "r1.fq", "w") as f:
        names = list(genomes)
        for i in range(24):
            g = genomes[names[i % 3]]
            pos = int(rng.integers(0, 500 - 120))
            f.write(f"@q{i}\n{g[pos:pos + 120]}\n+\n{'I' * 120}\n")
    db = tmp / "DB"
    jcli.main(["--parse-fasta", "--output-file", str(db), str(fa)])
    (tmp / "names.dmp").write_text("1\t|\troot\t|\t\t|\tscientific name\t|\n")
    (tmp / "nodes.dmp").write_text("1\t|\t1\t|\tno rank\t|\n")
    jcli.main(["--parse-taxonomy", str(tmp / "names.dmp"),
               str(tmp / "nodes.dmp"), "--output-file", f"{db}/taxDB"])
    return tmp, str(db), str(tmp / "r1.fq")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_processes(dbs, r1, flags):
    """Runs the port's CLI as processes 0 and 1 (process p on DB
    dbs[p]); returns their (exit code, stderr)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kslam_tpu_torch.cli", "--db", db,
         "--device", "cpu", "--num-reads-at-once", "6", *flags,
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(pid), r1],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid, db in enumerate(dbs)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=240)[1].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, err) for p, err in zip(procs, errs)]


def _two_processes(db, r1, flags):
    """Both processes on `db`; each must succeed.  Returns their stderr."""
    results = _run_processes([db, db], r1, flags)
    for rc, err in results:
        assert rc == 0, err[-3000:]
    return [err for _, err in results]


@pytest.fixture(scope="module")
def reference(dataset):
    """One kslam_tpu.cli process with --sam-file: its SAM (the SAM text
    does not depend on --just-align) and its XML/TSV outputs."""
    tmp, db, r1 = dataset
    out = tmp / "single"
    assert jcli.main(["--db", db, "--output-file", str(out),
                      "--sam-file", f"{out}.sam", "--device-pipeline", "on",
                      "--num-reads-at-once", "6", r1]) == 0
    return out


def test_two_process_just_align_sam(dataset, reference):
    tmp, db, r1 = dataset
    single = f"{reference}.sam"
    merged = str(tmp / "multi.sam")
    _two_processes(db, r1, ["--output-file", str(tmp / "multi"),
                            "--sam-file", merged, "--just-align"])

    def body(path):
        return sorted(line for line in open(path) if not line.startswith("@"))

    def header(path):
        return [line for line in open(path)
                if line.startswith("@") and not line.startswith("@PG")]

    assert not os.path.exists(merged + ".part0")
    assert not os.path.exists(merged + ".part1")
    assert open(merged).read().count("@HD") == 1
    assert header(merged) == header(single)
    assert body(merged) == body(single) and len(body(single)) >= 24


def test_two_process_columnar_classification(dataset, reference, tmp_path):
    tmp, db, r1 = dataset
    errs = _two_processes(db, r1, ["--output-file", str(tmp_path / "multi")])
    for err in errs:
        # the merge rides compact columnar blocks, two per process
        assert "gathering 2/2 columnar blocks" in err, err[-3000:]
    for suffix in ("", "_PerRead", "_abbreviated"):
        assert (tmp_path / f"multi{suffix}").read_text() == \
            open(f"{reference}{suffix}").read(), suffix
    assert len(open(f"{reference}_PerRead").read()) > 0


def test_failed_peer_fails_the_run(dataset, tmp_path):
    """Process 1 dies (its DB is missing): process 0 must exit non-zero
    when its collective loses the peer, not hang."""
    tmp, db, r1 = dataset
    results = _run_processes([db, str(tmp_path / "no_db")], r1,
                             ["--output-file", str(tmp_path / "out")])
    assert results[1][0] != 0 and "No such file" in results[1][1]
    assert results[0][0] != 0 and "closed by peer" in results[0][1], \
        results[0][1][-3000:]
