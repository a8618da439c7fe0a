"""Tests of kslam_tpu_torch that need a CUDA device: the hand-written SW
kernels against their plain torch versions (the forward kernel and the
fused forward + reverse kernel: odd shapes, n_valid, every row-count
instantiation, wide scores, the chunked windows of the device pipeline),
the host screen on CUDA against the CPU, the join's kernels
(sector_join, bucket_join, window_join) against their plain versions,
the sector table built on the card against the CPU's bit for bit, the
DB's columns derived on the card (db/device_columns.py) against the host
versions bit for bit, and the join's four backends (sector table, bucket table, prefix window,
exact search) against each other on CUDA,
the sharded phase A of a mesh on CUDA against the CPU, the float32 pseudo-assembly on CUDA
against the CPU, the SAM path's sam_cigar (its group kernel, its passes
against sw_align, its long-read path) and sam_diff kernels against
their plain versions, and the CUDA CLI runs (classification and SAM, and
over four chunks at both chunk-pipeline depths) against the CPU ones.
They import neither jax nor kslam_tpu, so they run on the card's
machine with

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

and skip on a machine without a card."""

import os
import threading

import numpy as np
import pytest
import torch

from kslam_tpu_torch import cli
from kslam_tpu_torch.db import sector_table
from kslam_tpu_torch.db.genbank import GenbankEntry, GenbankIndex
from kslam_tpu_torch.db.host_table import HostTable
from kslam_tpu_torch.db.kmer_index import KmerIndex, join_columns
from kslam_tpu_torch.db.taxonomy import TaxonomyDB
from kslam_tpu_torch.eval import join_cases, sam_cases
from kslam_tpu_torch.eval.sw_windows import n_windows
from kslam_tpu_torch.ops import encode, join, join_cuda, kmers, match, \
    sam_cuda, screen, screens_dev, sw, sw_cuda
from kslam_tpu_torch.parallel import dist
from tests.torch_sam_staging import pass_columns, stage_plain

torch.set_num_threads(1)

PARAMS = [(2, 3, 5, 2), (1, 4, 6, 1), (3, 2, 2, 2)]
B4 = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the SW kernel has no CPU mode")
    return torch.device("cuda")


def _similar(rng, b, lq, lr, mut):
    q = rng.integers(0, 4, (b, lq)).astype(np.int32)
    r = rng.integers(0, 4, (b, lr)).astype(np.int32)
    off = rng.integers(0, lr - lq + 1, b)
    cp = q.copy()
    m = rng.random((b, lq)) < mut
    cp[m] = rng.integers(0, 4, int(m.sum()))
    np.put_along_axis(r, off[:, None] + np.arange(lq)[None, :], cp, axis=1)
    return q, r


@pytest.mark.cuda
@pytest.mark.parametrize("params", PARAMS)
def test_kernel_matches_plain(cuda_device, params):
    rng = np.random.default_rng(21)
    b, lq, lr = 4096, 160, 192
    q, r = _similar(rng, b, lq, lr, mut=0.05)
    q[rng.random((b, lq)) < 0.05] = 4
    q[::9] = 4                                       # all-N rows
    qd, rd = (torch.as_tensor(x, device=cuda_device) for x in (q, r))
    nv = torch.tensor(b - 77, dtype=torch.int32, device=cuda_device)
    before = sw_cuda.LAUNCHES
    got = sw_cuda.sw_forward_batch(qd, rd, *params, n_valid=nv)
    assert sw_cuda.LAUNCHES == before + 1
    ref = sw_cuda.sw_forward_batch_plain(qd, rd, *params, n_valid=nv)
    for a, b_ in zip(got, ref):
        assert torch.equal(a, b_)
    assert (got.score[b - 77:] == 0).all() and (got.ref_end[b - 77:] == -1).all()
    cpu = sw_cuda.sw_forward_batch(torch.as_tensor(q[:64]),
                                   torch.as_tensor(r[:64]), *params)
    for a, b_ in zip(got, cpu):
        assert torch.equal(a[:64].cpu(), b_)


def _assert_equal_to_plain(q, r, params, n_valid=None, config=None):
    nv = None if n_valid is None else torch.tensor(
        n_valid, dtype=torch.int32, device=q.device)
    before, cells = sw_cuda.LAUNCHES, sw_cuda.LAUNCH_CELLS
    if config is None:
        got = sw_cuda.sw_forward_batch(q, r, *params, n_valid=nv)
    else:
        got = sw_cuda._launch(q, r, *params, nv, config=config)
    assert sw_cuda.LAUNCHES == before + 1
    assert sw_cuda.LAUNCH_CELLS == cells + q.numel() * r.shape[1]
    ref = sw_cuda.sw_forward_batch_plain(q, r, *params, n_valid=nv)
    for a, b_ in zip(got, ref):
        assert torch.equal(a, b_)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lr", [(1, 1), (7, 5), (17, 33), (20, 192),
                                   (150, 192), (152, 192), (160, 192),
                                   (161, 192)])
def test_kernel_odd_shapes(cuda_device, lq, lr):
    """Shapes off the main path's exact fit: query rows padded with N up
    to G * R, tiny refs, and a batch (3001) that is not a multiple of the
    alignments per block."""
    rng = np.random.default_rng(lq * 1000 + lr)
    q, r = _similar(rng, 3001, min(lq, lr), lr, mut=0.05)
    q = np.concatenate([q, rng.integers(0, 5, (3001, lq - q.shape[1]))],
                       axis=1).astype(np.int32)
    q[rng.random(q.shape) < 0.03] = 4
    q[::13] = 4
    qd, rd = (torch.as_tensor(x, device=cuda_device) for x in (q, r))
    for params in PARAMS:
        _assert_equal_to_plain(qd, rd, params)


@pytest.mark.cuda
def test_kernel_largest_shape(cuda_device):
    """Lq = Lr = 1024 (G * R = 1024, the key's row limit), match 1."""
    rng = np.random.default_rng(1024)
    q, r = _similar(rng, 300, 1024, 1024, mut=0.1)
    q[::7] = 4
    _assert_equal_to_plain(torch.as_tensor(q, device=cuda_device),
                           torch.as_tensor(r, device=cuda_device),
                           (1, 4, 6, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["zero", "one", "b-1000", "odd"])
def test_kernel_n_valid(cuda_device, which):
    rng = np.random.default_rng(6)
    b = 4133
    q, r = _similar(rng, b, 160, 192, mut=0.05)
    per_block = sw_cuda.launch_config(b, 160, 192)
    per_block = per_block.threads // per_block.group
    nv = {"zero": 0, "one": 1, "b-1000": b - 1000,
          "odd": 7 * per_block + 3}[which]
    qd, rd = (torch.as_tensor(x, device=cuda_device) for x in (q, r))
    got = _assert_equal_to_plain(qd, rd, (2, 3, 5, 2), n_valid=nv)
    assert (got.score[nv:] == 0).all() and (got.ref_end[nv:] == -1).all()
    assert (got.read_end[nv:] == 0).all()
    assert nv == 0 or int(got.score[:nv].min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rows", sw_cuda.KERNEL_ROWS)
def test_kernel_every_instantiation(cuda_device, rows):
    """Each row count R with a group G that covers Lq = 100, against the
    twin."""
    rng = np.random.default_rng(rows)
    b, lq, lr = 1500, 100, 120
    q, r = _similar(rng, b, lq, lr, mut=0.08)
    q[rng.random((b, lq)) < 0.05] = 4
    group = next(g for g in (1, 2, 4, 8, 16, 32) if g * rows >= lq)
    cfg = sw_cuda._config_for(b, lr, group, rows)
    qd, rd = (torch.as_tensor(x, device=cuda_device) for x in (q, r))
    for params in PARAMS:
        _assert_equal_to_plain(qd, rd, params, n_valid=b - 11, config=cfg)


@pytest.mark.cuda
def test_kernel_wide_scores(cuda_device):
    """Scores outside int8 (match 200, mismatch 150) take the kernel's
    compare-and-select path; uint8 codes are widened to int32."""
    rng = np.random.default_rng(3)
    q, r = _similar(rng, 2000, 10, 90, mut=0.1)
    q[::9] = 4
    qd, rd = (torch.as_tensor(x, device=cuda_device).to(torch.uint8)
              for x in (q, r))
    _assert_equal_to_plain(qd, rd, (200, 150, 300, 10), n_valid=1990)


@pytest.mark.cuda
def test_chunked_alignment_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 50_000).astype(np.uint8)
    offsets = np.array([0, 30_000, 50_000], np.int64)
    chunks = sw.genome_chunks_from_scodes(genome)
    n_reads, l, b = 64, 152, 2000
    reads = rng.integers(0, 4, (n_reads, l)).astype(np.uint8)
    lens = rng.integers(100, l + 1, n_reads).astype(np.int32)
    args = (rng.integers(0, n_reads, b).astype(np.int32),
            rng.integers(0, 2, b).astype(np.int32),
            rng.integers(-20, 19_000, b).astype(np.int32),
            rng.random(b) < 0.5, np.ones(b, bool), reads, lens, chunks,
            offsets)
    fused = sw_cuda.ALIGN_LAUNCHES
    got = sw.align_overlaps_batch_chunked(
        *(torch.as_tensor(x, device=cuda_device) for x in args), 2, 3, 5, 2,
        window_len=l)
    assert sw_cuda.ALIGN_LAUNCHES == fused + 1
    ref = sw.align_overlaps_batch_chunked(
        *(torch.as_tensor(x) for x in args), 2, 3, 5, 2, window_len=l)
    for a, b_ in zip(got, ref):
        assert torch.equal(a.cpu(), b_)


@pytest.mark.cuda
@pytest.mark.parametrize("params", PARAMS)
def test_align_composition_matches_plain(cuda_device, params):
    """sw_align_batch (one fused launch) against the composition over the
    plain twin at the flat window's shapes, Lq = Lr = 160."""
    rng = np.random.default_rng(8)
    b = 4096
    q, r = _similar(rng, b, 160, 160, mut=0.05)
    q[::11] = 4                                      # all-N rows
    qd, rd = (torch.as_tensor(x, device=cuda_device) for x in (q, r))
    before, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    cells = sw_cuda.LAUNCH_CELLS
    got = sw_cuda.sw_align_batch(qd, rd, *params)
    assert sw_cuda.LAUNCHES == before + 1
    assert sw_cuda.ALIGN_LAUNCHES == fused + 1
    assert sw_cuda.LAUNCH_CELLS == cells + 2 * b * 160 * 160
    ref = sw_cuda.sw_align_batch_plain(qd, rd, *params)
    for a, b_ in zip(got, ref):
        assert torch.equal(a, b_)
    assert (got.ref_begin[::11] == -1).all()


def _assert_fused_equal_to_plain(q, r, params, n_valid=None, config=None):
    nv = None if n_valid is None else torch.tensor(
        n_valid, dtype=torch.int32, device=q.device)
    before, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    if config is None:
        got = sw_cuda.sw_align_batch(q, r, *params, n_valid=nv)
    else:
        got = sw_cuda._launch(q, r, *params, nv, config=config, align=True)
    assert sw_cuda.LAUNCHES == before + 1
    assert sw_cuda.ALIGN_LAUNCHES == fused + 1
    ref = sw_cuda.sw_align_batch_plain(q, r, *params, n_valid=nv)
    for a, b_ in zip(got, ref):
        assert torch.equal(a, b_)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("lq,lr", [(1, 1), (7, 5), (17, 33), (20, 192),
                                   (150, 192), (160, 160), (160, 192),
                                   (161, 192)])
def test_fused_kernel_odd_shapes(cuda_device, lq, lr):
    """The fused kernel against its plain version with trimmed windows,
    off the exact fit and at a batch (3001) off the block size."""
    rng = np.random.default_rng(lq * 1000 + lr + 1)
    q, r = _similar(rng, 3001, min(lq, lr), lr, mut=0.05)
    q = np.concatenate([q, rng.integers(0, 5, (3001, lq - q.shape[1]))],
                       axis=1).astype(np.int32)
    q[rng.random(q.shape) < 0.03] = 4
    q[::13] = 4
    q, r = n_windows(rng, q, r)
    qd, rd = (torch.as_tensor(x, device=cuda_device) for x in (q, r))
    for params in PARAMS:
        got = _assert_fused_equal_to_plain(qd, rd, params)
        assert int(got.score.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["zero", "one", "b-1", "b", "odd"])
def test_fused_kernel_n_valid(cuda_device, which):
    rng = np.random.default_rng(16)
    b = 4133
    q, r = n_windows(rng, *_similar(rng, b, 160, 192, mut=0.05))
    cfg = sw_cuda.launch_config(b, 160, 192, align=True)
    nv = {"zero": 0, "one": 1, "b-1": b - 1, "b": b,
          "odd": 7 * (cfg.threads // cfg.group) + 3}[which]
    qd, rd = (torch.as_tensor(x, device=cuda_device) for x in (q, r))
    got = _assert_fused_equal_to_plain(qd, rd, (2, 3, 5, 2), n_valid=nv)
    for col, dead in zip(got, (0, -1, -1, 0, 0)):
        assert (col[nv:] == dead).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", sw_cuda.KERNEL_ROWS)
def test_fused_kernel_every_instantiation(cuda_device, rows):
    rng = np.random.default_rng(rows + 100)
    b, lq, lr = 1500, 100, 120
    q, r = n_windows(rng, *_similar(rng, b, lq, lr, mut=0.08))
    group = next(g for g in (1, 2, 4, 8, 16, 32) if g * rows >= lq)
    cfg = sw_cuda._config_for(b, lr, group, rows, align=True)
    qd, rd = (torch.as_tensor(x, device=cuda_device) for x in (q, r))
    for params in PARAMS:
        _assert_fused_equal_to_plain(qd, rd, params, n_valid=b - 11,
                                     config=cfg)


@pytest.mark.cuda
def test_fused_kernel_largest_shape_and_wide_scores(cuda_device):
    """Lq = Lr = 1024 with match 1; scores outside int8 (the
    compare-and-select path) on uint8 codes."""
    rng = np.random.default_rng(1025)
    q, r = n_windows(rng, *_similar(rng, 300, 1024, 1024, mut=0.1))
    _assert_fused_equal_to_plain(torch.as_tensor(q, device=cuda_device),
                                 torch.as_tensor(r, device=cuda_device),
                                 (1, 4, 6, 1))
    q, r = n_windows(rng, *_similar(rng, 2000, 10, 90, mut=0.1))
    qd, rd = (torch.as_tensor(x, device=cuda_device).to(torch.uint8)
              for x in (q, r))
    _assert_fused_equal_to_plain(qd, rd, (200, 150, 300, 10), n_valid=1990)


@pytest.mark.cuda
def test_screen_cuda_matches_cpu(cuda_device):
    """screen_reads on CUDA tensors against CPU tensors, with the sorted
    table and with the full 2^27-word bitset built from the same host."""
    rng = np.random.default_rng(2)
    host = B4[rng.integers(0, 4, 20_000)].tobytes().decode()
    gindex = GenbankIndex([GenbankEntry(bases=host)])
    bases = np.zeros((3000, 160), np.uint8)
    lengths = rng.integers(10, 161, 3000).astype(np.int32)
    for i in range(3000):
        if i % 2:
            p = int(rng.integers(0, len(host) - 160))
            seq = np.frombuffer(host[p:p + 160].encode(), np.uint8).copy()
            mut = rng.random(160) < (i % 7) * 0.01
            seq[mut] = B4[rng.integers(0, 4, int(mut.sum()))]
        else:
            seq = B4[rng.integers(0, 4, 160)]
        bases[i, :lengths[i]] = seq[:lengths[i]]
    bases[::13, :80] = ord("A")                       # low complexity
    outs = []
    for kind in ("sorted", "bitset"):
        table = HostTable.build(gindex, kind=kind)
        for dev in ("cpu", cuda_device):
            outs.append(screen.screen_reads(
                torch.as_tensor(bases, device=dev),
                torch.as_tensor(lengths, device=dev),
                screen.table_tensor(table, dev), lookup_kind=kind))
    for out in outs[1:]:
        for a, b_ in zip(out, outs[0]):
            assert torch.equal(a.cpu(), b_)
    assert 200 < int(outs[0][0].sum()) < 1500


def _small_db(root, rng):
    genomes = [B4[rng.integers(0, 4, 5000)] for _ in range(3)]
    gindex = GenbankIndex([GenbankEntry(bases=g.tobytes().decode(),
                                        taxonomy_id=10 + i, locus_tag=f"G{i}")
                           for i, g in enumerate(genomes)])
    gindex.save(str(root))
    KmerIndex.build(gindex).save(str(root))
    tax = TaxonomyDB()
    for t, p in {1: 1, 2: 1, 10: 2, 11: 2, 12: 2}.items():
        tax.parent_of[t], tax.rank_of[t], tax.name_of[t] = p, "no rank", f"t{t}"
    tax.write_index(str(root / "taxDB"))
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    with open(root / "r1.fq", "wb") as f1, open(root / "r2.fq", "wb") as f2:
        for i in range(200):
            g = genomes[i % 3].tobytes()
            pos = int(rng.integers(0, len(g) - 450))
            f1.write(b"@p%d\n%s\n+\n%s\n" % (i, g[pos:pos + 150], b"I" * 150))
            f2.write(b"@p%d\n%s\n+\n%s\n" % (
                i, g[pos + 250:pos + 400].translate(comp)[::-1], b"I" * 150))


@pytest.mark.cuda
def test_cli_cuda_matches_cpu(cuda_device, tmp_path):
    _small_db(tmp_path, np.random.default_rng(3))
    outs = {}
    for device in ("cpu", "cuda"):
        before = sw_cuda.LAUNCHES
        out = tmp_path / f"out_{device}"
        assert cli.main(["--db", str(tmp_path), "--output-file", str(out),
                         "--device", device, str(tmp_path / "r1.fq"),
                         str(tmp_path / "r2.fq")]) == 0
        assert (sw_cuda.LAUNCHES > before) == (device == "cuda")
        outs[device] = [open(str(out) + s).read()
                        for s in ("", "_PerRead", "_abbreviated")]
    assert outs["cuda"] == outs["cpu"]
    assert os.path.getsize(str(tmp_path / "out_cuda_PerRead")) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("flags", [[], ["--device-pipeline", "off"]],
                         ids=["device_pipeline", "host_path"])
def test_sam_cli_cuda_matches_cpu(cuda_device, tmp_path, flags):
    _small_db(tmp_path, np.random.default_rng(5))
    outs = {}
    for device in ("cpu", "cuda"):
        before = sw_cuda.LAUNCHES
        out = tmp_path / f"out_{device}"
        assert cli.main(["--db", str(tmp_path), "--output-file", str(out),
                         "--sam-file", str(out) + ".sam", "--device", device]
                        + flags + [str(tmp_path / "r1.fq"),
                                   str(tmp_path / "r2.fq")]) == 0
        assert (sw_cuda.LAUNCHES > before) == (device == "cuda")
        outs[device] = [open(str(out) + s).read()
                        for s in ("", "_PerRead", "_abbreviated")]
        outs[device].append([line for line in open(str(out) + ".sam")
                             if not line.startswith("@PG")])
    assert outs["cuda"] == outs["cpu"]
    assert len(outs["cuda"][3]) > 400


@pytest.mark.cuda
@pytest.mark.parametrize("flags,sam", [([], False), ([], True),
                                       (["--mesh", "2x2"], False)],
                         ids=["classify", "sam", "mesh_2x2"])
def test_chunk_pipeline_cuda_matches_depth1_and_cpu(cuda_device, tmp_path,
                                                    flags, sam):
    """Four chunks of 50 pairs: the pipelined cuda run (depth 3) writes
    byte for byte what the --no-chunk-overlap cuda run and the cpu run
    write, and leaves no worker thread."""
    _small_db(tmp_path, np.random.default_rng(7))
    outs = {}
    for name, device, extra in (("cpu", "cpu", []), ("d1", "cuda",
                                ["--no-chunk-overlap"]),
                                ("d3", "cuda", [])):
        out = tmp_path / f"out_{name}"
        args = ["--db", str(tmp_path), "--output-file", str(out),
                "--device", device, "--num-reads-at-once", "50"] + flags \
            + extra + (["--sam-file", str(out) + ".sam"] if sam else [])
        assert cli.main(args + [str(tmp_path / "r1.fq"),
                                str(tmp_path / "r2.fq")]) == 0
        outs[name] = [open(str(out) + s).read()
                      for s in ("", "_PerRead", "_abbreviated")]
        if sam:
            outs[name].append([line for line in open(str(out) + ".sam")
                               if not line.startswith("@PG")])
    assert outs["d3"] == outs["d1"] == outs["cpu"]
    assert outs["d3"][1]
    assert not [t for t in threading.enumerate()
                if t.name.startswith("kslam-chunk")]


def _leaves(x):
    """The tensors of nested NamedTuples, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for v in x for t in _leaves(v)]
    return []


def _mesh_phase_a(device, gshard, gindex, kidx, bases, lengths, mid):
    mesh = dist.build_mesh(dist.local_devices(device), data=2, index=2)
    sdb = dist.place_sharded_db(mesh, kidx, gindex.bases_concat,
                                gindex.entry_offsets, genome_sharded=gshard)
    step = dist.make_sharded_phase_a(
        mesh, paired=True, match_s=2, mismatch=3, gap_open=5, gap_extend=2,
        window_len=160, genome_sharded=gshard)
    packed, nbits, kbits = encode.pack_reads_np(bases)
    return dist.split_phase_a(step(packed, lengths, mid, sdb, nbits=nbits,
                                   kbits=kbits), mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("gshard", [False, True],
                         ids=["replicated_genomes", "entry_owner_sw"])
def test_mesh_phase_a_matches_cpu(cuda_device, gshard):
    """The sharded phase A of a (2, 2) mesh on the card (every cell on
    the visible cards, cycled) equals the same mesh on the CPU, column
    by column, with entry-owner SW routing under genome sharding."""
    rng = np.random.default_rng(11)
    genomes = [B4[rng.integers(0, 4, 4000)] for _ in range(5)]
    gindex = GenbankIndex([GenbankEntry(bases=g.tobytes().decode(),
                                        taxonomy_id=10 + i, locus_tag=f"G{i}")
                           for i, g in enumerate(genomes)])
    kidx = KmerIndex.build(gindex)
    comp = np.zeros(256, np.uint8)
    comp[B4] = np.frombuffer(b"TGCA", np.uint8)
    unit = 96                                 # pairs per data row
    bases = np.zeros((4 * unit, 160), np.uint8)
    for d in range(2):
        for i in range(unit):
            g = genomes[int(rng.integers(0, 5))]
            pos = int(rng.integers(0, len(g) - 450))
            r1 = g[pos:pos + 150].copy()
            r1[rng.random(150) < 0.02] = B4[rng.integers(0, 4)]
            bases[2 * d * unit + i, :150] = r1
            bases[(2 * d + 1) * unit + i, :150] = \
                comp[g[pos + 250:pos + 400]][::-1]
    lengths = np.full(4 * unit, 150, np.int32)
    before = sw_cuda.LAUNCHES
    got = _mesh_phase_a("cuda", gshard, gindex, kidx, bases, lengths, unit)
    assert sw_cuda.LAUNCHES > before
    want = _mesh_phase_a("cpu", gshard, gindex, kidx, bases, lengths, unit)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert int(w.pairs.count) > unit // 2
        for a, b_ in zip(_leaves(g), _leaves(w)):
            assert torch.equal(a.cpu(), b_)


@pytest.mark.cuda
def test_pseudo_assembly_device_cuda_vs_cpu(cuda_device):
    """The float32 pseudo-assembly on the card against the CPU (which
    equals the reference package exactly): every column equal, the
    rescored float32 scores included, since every chain's sums add its
    rows in row order on both devices."""
    rng = np.random.default_rng(9)
    p = 200_000
    entry = rng.integers(0, 64, p).astype(np.int32)
    start = rng.integers(0, 200_000, p).astype(np.int32)
    span = rng.integers(60, 160, p).astype(np.int32)
    span[rng.random(p) < 0.01] = 0
    cols = (rng.integers(0, p // 2, p).astype(np.int32),
            rng.integers(-1, p, p).astype(np.int32),
            rng.integers(-1, p, p).astype(np.int32),
            rng.integers(0, 320, p).astype(np.int64), entry, start,
            (start + span).astype(np.int32),
            rng.integers(0, 600, p).astype(np.int64), rng.random(p) < 0.9)
    cpu = screens_dev.pseudo_assembly_device(screens_dev.PairCols(
        *(torch.as_tensor(c) for c in cols)))
    gpu = screens_dev.pseudo_assembly_device(screens_dev.PairCols(
        *(torch.as_tensor(c, device=cuda_device) for c in cols)))
    a = gpu.combined_score.cpu().numpy()
    b_ = cpu.combined_score.numpy()
    changed = int((b_ != cols[3]).sum())
    differ = int((a != b_).sum())
    print(f"pseudo_assembly_device cuda vs cpu: {differ} of {p} rows differ "
          f"({changed} rows rescored on the CPU)")
    assert changed > p // 2
    assert differ == 0
    for name in screens_dev.PairCols._fields:
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name))


def _card_join_bounds(q, q_ok, keys, name, **tables):
    """match.join_bounds on the card: one launch of `name`, with the
    CUDA sync debug mode at "error", so any host synchronisation inside
    it raises."""
    before = dict(join_cuda.JOIN_LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = match.join_bounds(q, q_ok, keys, **tables)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = dict(join_cuda.JOIN_LAUNCHES)
    assert after[name] == before[name] + 1, name
    assert sum(after.values()) == sum(before.values()) + 1, name
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("skewed", [False, True], ids=["random", "skewed"])
def test_join_backends_agree_on_cuda(cuda_device, skewed):
    """match.join_bounds through the sector table (built on each device
    from its keys), the bucket table and the prefix window gives the (lo,
    hi) of searchsorted_both on the card, and the CPU's
    join_bounds on every query; on the card each is one launch of its
    kernel, tier 2 inside it, with no host synchronisation; skewed keys
    (runs of 300 and 40 equal keys, a dense cluster of one prefix) leave
    queries to tier 2."""
    rng = np.random.default_rng(23)
    words = rng.integers(0, 2**64 - 1, 200_000, dtype=np.uint64)
    if skewed:
        words = np.concatenate([
            words, np.full(300, words[5]), np.full(40, words[9]),
            words[11] + rng.integers(0, 4096, 3000, dtype=np.uint64)])
    words = np.sort(words)
    z = np.zeros(len(words), np.int32)
    kidx = KmerIndex(words, z, z, np.zeros(len(words), bool))
    keys, _, pstart, bits, window = join_columns(kidx)
    tbl, bbits = kidx.bucket_table()
    q_words = np.concatenate([rng.choice(words, 100_000),
                              rng.integers(0, 2**64 - 1, 100_000,
                                           dtype=np.uint64)])
    q_np = kmers.keys_from_words_np(q_words)
    ok_np = rng.random(len(q_np)) < 0.9
    results = {}
    for dev in ("cpu", cuda_device):
        k = torch.as_tensor(keys).to(dev)
        q = torch.as_tensor(q_np).to(dev)
        q_ok = torch.as_tensor(ok_np).to(dev)
        exact = join.searchsorted_both(k, q)
        sbits = sector_table.default_bits(len(words))
        tables = {
            "sector_join": dict(
                idx_sector=sector_table.build(k, len(words), sbits),
                sector_bits=sbits),
            "bucket_join": dict(
                idx_bucket=torch.from_numpy(np.array(tbl)).to(dev),
                bucket_bits=bbits),
            "window_join": dict(idx_pstart=torch.as_tensor(pstart).to(dev),
                                prefix_bits=bits, window=window)}
        if skewed:
            assert int((q_ok & (join.lookup_sector(
                tables["sector_join"]["idx_sector"], q,
                sbits)[2] > 0)).sum()) > 0
            assert int((q_ok & (join.lookup_bucket(
                tables["bucket_join"]["idx_bucket"], q,
                bbits)[2] > 0)).sum()) > 0
            assert int((q_ok & (join.lookup_prefix_window(
                k, tables["window_join"]["idx_pstart"], q, bits,
                window)[2] > 0)).sum()) > 0
        for name, kw in tables.items():
            if dev == "cpu":
                got = match.join_bounds(q, q_ok, k, **kw)
            else:
                got = _card_join_bounds(q, q_ok, k, name, **kw)
            for a, b_ in zip(got, exact):
                assert torch.equal(a[q_ok], b_[q_ok]), name
            results[(str(dev), name)] = [x.cpu() for x in got]
        results[(str(dev), "exact")] = [x.cpu() for x in exact]
    for name in ("sector_join", "bucket_join", "window_join", "exact"):
        for a, b_ in zip(results[("cpu", name)],
                         results[(str(cuda_device), name)]):
            assert torch.equal(a, b_), name
    np.testing.assert_array_equal(results[("cpu", "exact")][0].numpy(),
                                  np.searchsorted(words, q_words, "left"))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bucket16", "bucket21", "runs4", "runs16",
                                  "runs128", "runs4096", "shard"])
def test_fused_join_bounds_on_edges(cuda_device, case):
    """join_bounds on the card equals the CPU's on every query for every
    q_ok pattern: the bucket table with every count 0..8 and both escapes
    (2^16 and 2^21 rows), prefix windows with long runs and real all-ones
    keys at w = 4 to 4096, and a mesh shard's collapsed prefixes; one
    launch each, with no host synchronisation."""
    rng = np.random.default_rng(89)
    if case.startswith("bucket"):
        bits = int(case[6:])
        words = join_cases.bucket_index_words(rng, bits=bits)
        tbl, bits = KmerIndex(words, *(np.zeros(len(words), t) for t in (
            np.int32, np.int32, bool))).bucket_table(bits=bits)
        padded = join_cases.sentinel_padded(words, 16)
        name = "bucket_join"
        tables = dict(idx_bucket=torch.from_numpy(tbl), bucket_bits=bits)
    else:
        bits, window = (6, int(case[4:])) if case != "shard" else (8, 16)
        words, padded, pstart = join_cases.run_edge_words(rng, bits, window)
        if case == "shard":
            padded, pstart = join_cases.prefix_shard(
                words, pstart, len(words) // 3, 2 * len(words) // 3, window)
        name = "window_join"
        tables = dict(idx_pstart=torch.as_tensor(pstart), prefix_bits=bits,
                      window=window)
    keys = torch.as_tensor(kmers.keys_from_words_np(padded))
    q = torch.as_tensor(kmers.keys_from_words_np(
        join_cases.queries_for(words, rng, 20_000)))
    for mask in ("all", "none", "random"):
        ok = {"all": np.ones(q.shape[0], bool),
              "none": np.zeros(q.shape[0], bool),
              "random": rng.random(q.shape[0]) < 0.5}[mask]
        q_ok = torch.as_tensor(ok)
        want = match.join_bounds(q, q_ok, keys, **tables)
        got = _card_join_bounds(
            q.to(cuda_device), q_ok.to(cuda_device), keys.to(cuda_device),
            name, **{k: v.to(cuda_device) if isinstance(v, torch.Tensor)
                     else v for k, v in tables.items()})
        for a, b_ in zip(got, want):
            assert a.device.type == "cuda" and a.dtype == torch.int64
            assert torch.equal(a.cpu(), b_), (case, mask)


def _kernel_vs_plain(kernel, plain, cpu_args, dev, name):
    """kernel(*args on dev) == plain(*args on dev) == plain(*cpu_args) on
    every query (lo, hi, uncovered), with one launch of `name` (none for
    zero queries)."""
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a
            for a in cpu_args]
    before = join_cuda.JOIN_LAUNCHES[name]
    got = kernel(*args)
    n = args[-3].numel() if name == "window_join" else args[1].numel()
    assert join_cuda.JOIN_LAUNCHES[name] == before + (n > 0)
    want = plain(*args)
    torch.cuda.synchronize()
    cpu = plain(*cpu_args)
    for a, b_, c in zip(got, want, cpu):
        assert a.device.type == "cuda" and a.dtype == c.dtype
        assert torch.equal(a, b_) and torch.equal(a.cpu(), c)
    return [x.cpu().numpy() for x in got]


def _realistic_index():
    from kslam_tpu_torch.eval import realistic
    entries = realistic.make_realistic_entries(n_genomes=2, bp_each=60_000,
                                               seed=7, plasmid_bp=8_000)
    return KmerIndex.build(GenbankIndex([
        GenbankEntry(bases=e.seq.tobytes().decode()) for e in entries]))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "edges16", "edges21",
                                  "realistic"])
def test_bucket_join_matches_plain(cuda_device, case):
    """The bucket_join kernel gives lookup_bucket_plain's (lo, hi,
    uncovered) on every query: random words, the edge words with every
    bucket count 0..8 and both kinds of escape (tables of 2^16 and 2^21
    rows), and a repeat-rich eval/realistic index whose pileups escape."""
    rng = np.random.default_rng(47)
    bits = None
    if case == "random":
        words = np.sort(rng.integers(0, 2**64 - 1, 200_000,
                                     dtype=np.uint64))
        kidx = KmerIndex(words, *(np.zeros(len(words), t)
                                  for t in (np.int32, np.int32, bool)))
    elif case == "realistic":
        kidx = _realistic_index()
        words = kidx.kmers
    else:
        bits = int(case[5:])
        words = join_cases.bucket_index_words(rng, bits=bits)
        kidx = KmerIndex(words, *(np.zeros(len(words), t)
                                  for t in (np.int32, np.int32, bool)))
    tbl, bits = kidx.bucket_table(bits=bits)
    q = torch.as_tensor(kmers.keys_from_words_np(
        join_cases.queries_for(words, rng, 100_000)))
    lo, hi, unc = _kernel_vs_plain(
        join.lookup_bucket, join.lookup_bucket_plain,
        [torch.from_numpy(np.array(tbl)), q, bits], cuda_device,
        "bucket_join")
    if case != "random":
        assert (unc > 0).any()
    assert (unc == 0).mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("bits,window", [(12, 4), (10, 8), (8, 16), (9, 32),
                                         (10, 64), (12, 128), (8, 2),
                                         (9, 256)])
def test_window_join_matches_plain(cuda_device, bits, window):
    """The window_join kernel gives lookup_prefix_window_plain's (lo, hi,
    uncovered) on every query at windows 2 to 256, an uncovered run and
    the all-ones word included."""
    rng = np.random.default_rng(53)
    km, padded, pstart = join_cases.prefix_index_words(rng, bits, window)
    q = join_cases.queries_for(km, rng)
    lo, hi, unc = _kernel_vs_plain(
        join.lookup_prefix_window, join.lookup_prefix_window_plain,
        [torch.as_tensor(kmers.keys_from_words_np(padded)),
         torch.as_tensor(pstart),
         torch.as_tensor(kmers.keys_from_words_np(q)), bits, window],
        cuda_device, "window_join")
    covered = unc == 0
    assert covered.any() and not covered.all()
    np.testing.assert_array_equal(lo[covered],
                                  np.searchsorted(km, q[covered], "left"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 4097])
def test_join_kernels_at_query_counts(cuda_device, n):
    """Query counts off the block (256 threads, one query each) and zero
    queries, which launch nothing; a [1, n] query tensor keeps its
    shape."""
    rng = np.random.default_rng(59)
    words = join_cases.bucket_index_words(rng, n_random=2000)
    tbl, bits = KmerIndex(words, *(np.zeros(len(words), t) for t in (
        np.int32, np.int32, bool))).bucket_table()
    km, padded, pstart = join_cases.prefix_index_words(rng, 8, 16)
    qw = join_cases.queries_for(words, rng)
    q = torch.as_tensor(kmers.keys_from_words_np(
        qw[rng.integers(0, len(qw), n)])).reshape(1, n)
    _kernel_vs_plain(join.lookup_bucket, join.lookup_bucket_plain,
                     [torch.from_numpy(tbl), q, bits], cuda_device,
                     "bucket_join")
    _kernel_vs_plain(join.lookup_sector, join.lookup_sector_plain,
                     [_sector_of(words, 16), q, 16], cuda_device,
                     "sector_join")
    _kernel_vs_plain(join.lookup_prefix_window,
                     join.lookup_prefix_window_plain,
                     [torch.as_tensor(kmers.keys_from_words_np(padded)),
                      torch.as_tensor(pstart), q, 8, 16], cuda_device,
                     "window_join")


@pytest.mark.cuda
def test_join_kernels_on_several_tables_and_cards(cuda_device):
    """Two indexes' tables on one card, queried in turns, each gives its
    own plain result; on every visible card the launch leaves the
    caller's current device as it was."""
    rng = np.random.default_rng(61)
    cases = []
    for n_random in (3000, 7000):
        words = join_cases.bucket_index_words(rng, n_random=n_random)
        tbl, bits = KmerIndex(words, *(np.zeros(len(words), t) for t in (
            np.int32, np.int32, bool))).bucket_table()
        km, padded, pstart = join_cases.prefix_index_words(
            rng, 9, 32, m=n_random)
        q = torch.as_tensor(kmers.keys_from_words_np(
            join_cases.queries_for(words, rng)))
        cases.append((torch.from_numpy(tbl), bits,
                      torch.as_tensor(kmers.keys_from_words_np(padded)),
                      torch.as_tensor(pstart), q))
    current = torch.cuda.current_device()
    for k in range(torch.cuda.device_count()):
        dev = torch.device("cuda", k)
        for tbl, bits, keys, pstart, q in cases + cases[::-1]:
            _kernel_vs_plain(join.lookup_bucket, join.lookup_bucket_plain,
                             [tbl, q, bits], dev, "bucket_join")
            _kernel_vs_plain(join.lookup_prefix_window,
                             join.lookup_prefix_window_plain,
                             [keys, pstart, q, 9, 32], dev, "window_join")
            assert torch.cuda.current_device() == current


@pytest.mark.cuda
def test_join_bounds_with_the_kernels(cuda_device):
    """match.join_bounds on the card, one launch of each kernel (the
    sector table's, the bucket table's, the window's) with its tier 2
    inside, gives the exact search's (lo, hi) on every kept query
    of a repeat-rich index's reads, and the CPU's join_bounds on every
    query, with no host synchronisation."""
    kidx = _realistic_index()
    keys, _, pstart, bits, window = join_columns(kidx)
    tbl, bbits = kidx.bucket_table()
    rng = np.random.default_rng(67)
    words = join_cases.queries_for(kidx.kmers, rng, 50_000)
    q_np = kmers.keys_from_words_np(words)
    # kept as the path keeps them: not the zero k-mer, and never the
    # all-ones word (no canonical k-mer is all ones), which the exact
    # search counts against every sentinel of the padding
    ok_np = (rng.random(len(q_np)) < 0.95) & (q_np != kmers.FLIP) & \
        (words != join_cases.ALL_ONES)
    out = {}
    for dev in ("cpu", cuda_device):
        k = torch.as_tensor(keys).to(dev)
        q = torch.as_tensor(q_np).to(dev)
        q_ok = torch.as_tensor(ok_np).to(dev)
        exact = join.searchsorted_both(k, q)
        sbits = sector_table.default_bits(len(kidx))
        tables = {
            "sector_join": dict(
                idx_sector=sector_table.build(k, len(kidx), sbits),
                sector_bits=sbits),
            "bucket_join": dict(
                idx_bucket=torch.from_numpy(np.array(tbl)).to(dev),
                bucket_bits=bbits),
            "window_join": dict(idx_pstart=torch.as_tensor(pstart).to(dev),
                                prefix_bits=bits, window=window)}
        for name, kw in tables.items():
            if dev == "cpu":
                before = dict(join_cuda.JOIN_LAUNCHES)
                got = match.join_bounds(q, q_ok, k, **kw)
                assert join_cuda.JOIN_LAUNCHES == before
            else:
                got = _card_join_bounds(q, q_ok, k, name, **kw)
            for a, b_ in zip(got, exact):
                assert torch.equal(torch.where(q_ok, a, 0),
                                   torch.where(q_ok, b_, 0)), name
            out[(str(dev), name)] = [x.cpu() for x in got]
    for name in ("sector_join", "bucket_join", "window_join"):
        for a, b_ in zip(out[("cpu", name)], out[(str(cuda_device), name)]):
            assert torch.equal(a, b_)


def _sector_of(words, bits: int, device="cpu"):
    """The sector table of the sorted index words, built on `device` from
    their sentinel-padded keys."""
    keys = torch.as_tensor(kmers.keys_from_words_np(
        join_cases.sentinel_padded(words, 16))).to(device)
    return sector_table.build(keys, len(words), bits)


def _sector_case(case, rng):
    """(sorted index words, bits) of a sector-table case: random words at
    the default bits, the edge words with rows of every count 0..6 and
    both escapes (2^16 and 2^21 rows), few bits (most queries escape) or
    a repeat-rich eval/realistic index."""
    if case == "random":
        words = np.sort(rng.integers(0, 2**64 - 1, 200_000,
                                     dtype=np.uint64))
        return words, sector_table.default_bits(len(words))
    if case == "few_bits":
        words = np.sort(np.concatenate([
            rng.integers(0, 2**64 - 1, 50_000, dtype=np.uint64),
            join_cases.EDGES, np.full(300, join_cases.EDGES[7])]))
        return words, 12
    if case == "realistic":
        words = np.asarray(_realistic_index().kmers)
        return words, sector_table.default_bits(len(words))
    bits = int(case[5:])
    return join_cases.sector_index_words(rng, bits=bits), bits


SECTOR_CASES = ["random", "edges16", "edges21", "few_bits", "realistic"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SECTOR_CASES)
def test_sector_table_on_card_equals_cpu(cuda_device, case):
    """The sector table built on the card equals the CPU's bit for bit,
    at the default slices and at odd ones."""
    rng = np.random.default_rng(97)
    words, bits = _sector_case(case, rng)
    cpu = _sector_of(words, bits)
    card = _sector_of(words, bits, cuda_device)
    assert card.device.type == "cuda" and card.data_ptr() % 32 == 0
    assert torch.equal(card.cpu(), cpu)
    keys = torch.as_tensor(kmers.keys_from_words_np(
        join_cases.sentinel_padded(words, 16))).to(cuda_device)
    odd = sector_table.build(keys, len(words), bits, slice_keys=4099,
                             slice_rows=3001)
    assert torch.equal(odd.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("case", SECTOR_CASES)
def test_sector_join_matches_plain(cuda_device, case):
    """The sector_join kernel gives lookup_sector_plain's (lo, hi,
    uncovered) on every query (index words, their neighbours, random
    words, the edge words, the all-ones word)."""
    rng = np.random.default_rng(101)
    words, bits = _sector_case(case, rng)
    q = torch.as_tensor(kmers.keys_from_words_np(
        join_cases.queries_for(words, rng, 100_000)))
    lo, hi, unc = _kernel_vs_plain(
        join.lookup_sector, join.lookup_sector_plain,
        [_sector_of(words, bits), q, bits], cuda_device, "sector_join")
    if case != "random":
        assert (unc > 0).any()
    if case == "few_bits":
        assert (unc > 0).mean() > 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("case", SECTOR_CASES)
def test_sector_join_bounds_on_card(cuda_device, case):
    """match.join_bounds through the sector table on the card equals the
    CPU's on every query for every q_ok pattern, and the exact search on
    every kept query; one launch, with no host synchronisation."""
    rng = np.random.default_rng(103)
    words, bits = _sector_case(case, rng)
    keys = torch.as_tensor(kmers.keys_from_words_np(
        join_cases.sentinel_padded(words, 16)))
    tbl = _sector_of(words, bits)
    qw = join_cases.queries_for(words, rng, 50_000)
    q = torch.as_tensor(kmers.keys_from_words_np(qw))
    for mask in ("all", "none", "random"):
        ok = {"all": np.ones(len(qw), bool),
              "none": np.zeros(len(qw), bool),
              "random": rng.random(len(qw)) < 0.5}[mask]
        q_ok = torch.as_tensor(ok)
        want = match.join_bounds(q, q_ok, keys, idx_sector=tbl,
                                 sector_bits=bits)
        got = _card_join_bounds(
            q.to(cuda_device), q_ok.to(cuda_device), keys.to(cuda_device),
            "sector_join", idx_sector=tbl.to(cuda_device), sector_bits=bits)
        exact = join.searchsorted_both(keys, q)
        kept = q_ok & (q != kmers.keys_from_words_np(
            np.array([join_cases.ALL_ONES]))[0])
        for a, b_, c in zip(got, want, exact):
            assert a.device.type == "cuda" and a.dtype == torch.int64
            assert torch.equal(a.cpu(), b_), (case, mask)
            assert torch.equal(a.cpu()[kept], c[kept]), (case, mask)


@pytest.mark.cuda
def test_device_db_sector_table_on_card(cuda_device):
    """DeviceDB.from_index on the card builds the same sector table as on
    the CPU, 32 B aligned, from the keys it uploaded."""
    from kslam_tpu_torch.pipeline import align
    kidx = _realistic_index()
    gindex = GenbankIndex([GenbankEntry(bases="ACGT" * 100)])
    cpu = align.DeviceDB.from_index(gindex, kidx, "cpu")
    card = align.DeviceDB.from_index(gindex, kidx, cuda_device)
    assert card.sector_bits == cpu.sector_bits == \
        sector_table.default_bits(len(kidx))
    assert card.sector.device.type == "cuda"
    assert card.sector.data_ptr() % 32 == 0
    assert torch.equal(card.sector.cpu(), cpu.sector)


@pytest.mark.cuda
@pytest.mark.parametrize("stage_bytes", [None, 8 * 37])
def test_device_columns_on_card(cuda_device, monkeypatch, stage_bytes):
    """db/device_columns on the card: index_columns equals join_columns
    and genome_rows the host SW code rows, bit for bit, on a repeat-rich
    index (the prefix table's 99.9th-percentile branch) and a 256-value
    genome; with staging chunks of 37 keys the ring of pinned buffers
    wraps hundreds of times, each refill waiting on its event."""
    from kslam_tpu_torch.db import device_columns
    if stage_bytes:
        monkeypatch.setattr(device_columns, "STAGE_BYTES", stage_bytes)
        monkeypatch.setattr(device_columns, "SLICE", 333)
    kidx = _realistic_index()
    want = join_columns(kidx)
    got = device_columns.index_columns(kidx, cuda_device)
    for a, b_ in zip(got[:3], want[:3]):
        assert a.device.type == "cuda"
        np.testing.assert_array_equal(a.cpu().numpy(), b_)
    assert got[3:] == want[3:]
    bases = np.random.default_rng(5).permutation(
        np.resize(np.arange(256, dtype=np.uint8), 100_003))
    rows, flat = device_columns.genome_rows(bases, cuda_device, flat=True)
    np.testing.assert_array_equal(
        rows.cpu().numpy(),
        sw.genome_chunks_from_scodes(encode.sw_codes_np(bases)))
    np.testing.assert_array_equal(flat.cpu().numpy(),
                                  encode.sw_codes_np(bases))


def _sam_columns(n: int, seed: int):
    rng = np.random.default_rng(seed)
    c = sam_cases.alignments(rng, sam_cases.entries(rng), n)
    return c, rng


SW_DEFAULT = (2, 3, 5, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [(8, 32, 64), (1, 2, 3)],
                         ids=["default", "tiny_caps"])
def test_sam_kernels_match_plain(cuda_device, monkeypatch, caps):
    """sam_cigar and sam_diff on the card equal their plain versions on
    a synthetic mix of 4,096 alignments (forward and rc,
    indels, entry-end windows, N, lowercase); with tiny caps most rows
    take sam_cigar's relaunch, and sam_diff's texts need more than their
    caps (the lengths they report say so)."""
    w_cap, ops_cap, text_cap = caps
    monkeypatch.setattr(sam_cuda, "W_CAP", w_cap)
    monkeypatch.setattr(sam_cuda, "OPS_CAP", ops_cap)
    c, rng = _sam_columns(4096, 31)
    max_ops = sam_cuda.native_max_ops(c["lengths"])
    before = dict(sam_cuda.SAM_LAUNCHES)
    got = sam_cuda.sam_cigar(*sam_cases.cigar_operands(c, cuda_device),
                             SW_DEFAULT, 0, max_ops)
    assert sam_cuda.SAM_LAUNCHES["sam_cigar"] >= before["sam_cigar"] + 1
    # the first launch's band kernel, then the relaunch's (most rows
    # with tiny caps)
    assert sam_cuda.SAM_LAUNCHES["sam_band"] >= before["sam_band"] + (
        2 if w_cap == 1 else 1)
    want = sam_cuda.sam_cigar(*sam_cases.cigar_operands(c, "cpu"),
                              SW_DEFAULT, 0, max_ops)
    for k in ("score", "ref_begin", "ref_end", "query_begin", "query_end",
              "cigar_len"):
        assert torch.equal(got[k].cpu(), want[k]), k
    width = int(want["cigar_len"].max())
    assert got["cigar_buf"].shape[1] >= width
    assert torch.equal(got["cigar_buf"][:, :width].cpu(),
                       want["cigar_buf"][:, :width])
    rb, qb, qe = sam_cases.phase_a_ends(
        rng, want["ref_begin"].numpy(), want["query_begin"].numpy(),
        want["query_end"].numpy(), c["lengths"])
    buf = want["cigar_buf"][:, :max(width, 1)].numpy()
    cl = want["cigar_len"].numpy().copy()
    cl[::97] = sam_cuda.NO_CIGAR
    outs = [sam_cuda.sam_diff(*sam_cases.diff_operands(
        c, buf, cl, rb, qb, qe, dev), text_cap, text_cap)
        for dev in (cuda_device, "cpu")]
    assert sam_cuda.SAM_LAUNCHES["sam_diff"] >= before["sam_diff"] + 1
    for k in outs[1]:
        assert torch.equal(outs[0][k].cpu(), outs[1][k]), k
    if text_cap < 64:
        assert (outs[1]["md_n"] > text_cap).any()


@pytest.mark.cuda
def test_sam_cigar_raises_past_relaunch(cuda_device, monkeypatch):
    """A band that outgrows the relaunch's slab too raises: no row is
    handed on still flagged (sam_diff would read it as no cigar)."""
    monkeypatch.setattr(sam_cuda, "W_CAP", 1)
    monkeypatch.setattr(sam_cuda, "relaunch_width", lambda qmax: 1)
    c, _ = _sam_columns(512, 37)
    with pytest.raises(RuntimeError, match="outgrew the relaunch"):
        sam_cuda.sam_cigar(*sam_cases.cigar_operands(c, cuda_device),
                           SW_DEFAULT, 0, sam_cuda.native_max_ops(
                               c["lengths"]))


@pytest.mark.cuda
def test_sam_kernels_on_tandem_repeats(cuda_device):
    """The tie-heavy mix: tandem repeats on both sides, where many cells
    reach the max and the key's tie-break decides every end; sam_cigar
    and sam_diff equal to their plain versions."""
    rng = np.random.default_rng(53)
    c = sam_cases.tandem_alignments(rng, 2048)
    max_ops = sam_cuda.native_max_ops(c["lengths"])
    got, want = (sam_cuda.sam_cigar(*sam_cases.cigar_operands(c, dev),
                                    SW_DEFAULT, 0, max_ops)
                 for dev in (cuda_device, "cpu"))
    for k in ("score", "ref_begin", "ref_end", "query_begin", "query_end",
              "cigar_len"):
        assert torch.equal(got[k].cpu(), want[k]), k
    width = int(want["cigar_len"].max())
    assert torch.equal(got["cigar_buf"][:, :width].cpu(),
                       want["cigar_buf"][:, :width])
    buf = want["cigar_buf"][:, :max(width, 1)].numpy()
    rb, qb, qe = (want[k].numpy() for k in ("ref_begin", "query_begin",
                                           "query_end"))
    outs = [sam_cuda.sam_diff(*sam_cases.diff_operands(
        c, buf, want["cigar_len"].numpy(), rb.astype(np.int64), qb, qe,
        dev)) for dev in (cuda_device, "cpu")]
    for k in outs[1]:
        assert torch.equal(outs[0][k].cpu(), outs[1][k]), k


@pytest.mark.cuda
def test_sam_passes_equal_sw_align(cuda_device):
    """sam_cigar's passes (its score and ends: the band kernel only zeroes
    an aborted row's score) equal sw_align's kernel on the operands
    staged as sam_cigar stages them, and the plain version's ends: the
    group wavefront they share gives one answer.  One call launches the
    passes kernel and the band kernel once each, both counted."""
    c, _ = _sam_columns(4096, 59)
    ops = sam_cases.cigar_operands(c, cuda_device)
    reads, read_len, read_id, rc, win, wlen, ref_start = ops
    max_ops = sam_cuda.native_max_ops(c["lengths"])
    before = dict(sam_cuda.SAM_LAUNCHES)
    got = sam_cuda.sam_cigar(*ops, SW_DEFAULT, 0, max_ops)
    launched = {k: sam_cuda.SAM_LAUNCHES[k] - before[k] for k in before}
    assert launched["sam_cigar"] == 1 and launched["sam_band"] >= 1
    assert launched["sam_cigar_long"] == 0
    q, r, _, _, _ = stage_plain(reads, read_len, read_id, rc, win, wlen,
                                SW_DEFAULT)
    al = sw_cuda.sw_align_batch(q.int(), r.int(), *SW_DEFAULT)
    cols = pass_columns(al, read_len.long()[read_id.long()], wlen, rc,
                        ref_start)
    want = sam_cuda.sam_cigar(*sam_cases.cigar_operands(c, "cpu"),
                              SW_DEFAULT, 0, max_ops)
    live = got["cigar_len"] != sam_cuda.ABORTED
    assert torch.equal(got["score"].long()[live], cols[0][live])
    # the band kernel zeroes an aborted row's score, as the plain one does
    assert (got["score"][~live] == 0).all()
    for k, v in zip(("ref_begin", "ref_end", "query_begin", "query_end"),
                    cols[1:]):
        assert torch.equal(got[k].long(), v), k
        assert torch.equal(v.cpu(), want[k].long()), k


@pytest.mark.cuda
def test_sam_long_reads(cuda_device):
    """Reads of 1,100 bases, past the group kernel's key: sam_cigar runs
    sam_cigar_long (counted under its own name) and equals its plain
    version; sam_diff on them (rows past its staged 1 KB and MD texts
    past their staged 256 B in device memory) equals its plain
    version."""
    rng = np.random.default_rng(61)
    ents = sam_cases.entries(rng, n_entries=2, length=8000)
    c = sam_cases.alignments(rng, ents, 64, read_len=1100, stride=1104,
                             sub=0.1, indel_share=0.5)
    max_ops = sam_cuda.native_max_ops(c["lengths"])
    ops = sam_cases.cigar_operands(c, cuda_device)
    assert not sam_cuda.takes_group(ops[0].shape[1], ops[4].shape[1],
                                    SW_DEFAULT)
    before = dict(sam_cuda.SAM_LAUNCHES)
    got = sam_cuda.sam_cigar(*ops, SW_DEFAULT, 0, max_ops)
    assert sam_cuda.SAM_LAUNCHES["sam_cigar_long"] >= \
        before["sam_cigar_long"] + 1
    assert sam_cuda.SAM_LAUNCHES["sam_cigar"] == before["sam_cigar"]
    assert sam_cuda.SAM_LAUNCHES["sam_band"] == before["sam_band"]
    want = sam_cuda.sam_cigar(*sam_cases.cigar_operands(c, "cpu"),
                              SW_DEFAULT, 0, max_ops)
    for k in ("score", "ref_begin", "ref_end", "query_begin", "query_end",
              "cigar_len"):
        assert torch.equal(got[k].cpu(), want[k]), k
    width = int(want["cigar_len"].max())
    assert torch.equal(got["cigar_buf"][:, :width].cpu(),
                       want["cigar_buf"][:, :width])
    buf = want["cigar_buf"][:, :max(width, 1)].numpy()
    rb, qb, qe = sam_cases.phase_a_ends(
        rng, want["ref_begin"].numpy(), want["query_begin"].numpy(),
        want["query_end"].numpy(), c["lengths"])
    outs = [sam_cuda.sam_diff(*sam_cases.diff_operands(
        c, buf, want["cigar_len"].numpy(), rb, qb, qe, dev), 2048, 2048)
        for dev in (cuda_device, "cpu")]
    for k in outs[1]:
        assert torch.equal(outs[0][k].cpu(), outs[1][k]), k
    # walks past the staged 1 KB of a row and texts past the staged 256 B
    assert int(outs[1]["ref_need"].max()) > 1024
    assert 256 < int(outs[1]["md_n"].max()) <= 2048
