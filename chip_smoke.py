"""Chip smoke test of the PyTorch/CUDA port (kslam_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--mbp 1600] [--pairs 131072]
                          [--host-pairs 16384]

Phases (each prints its own line; any failure exits non-zero):
  1. device: the card's name and power limit; a CUDA device is required.
  2. build: the SW kernel (nvcc, kslam_tpu_torch/csrc) and the native
     host library (make -C csrc, the first of $CXX, g++, c++ that links
     OpenMP), built in parallel; the library must load.
  3. kernel vs plain: the SW kernel against its plain torch twin on the
     card at the main path's shapes (B = 32768, Lq = 160, Lr = 192):
     random codes with 5% N, planted near-identical pairs, all-N rows,
     n_valid of 0, 1, B - 1000 and one off the block size, three scoring
     parameter sets, and once through align_overlaps_batch_chunked (both
     passes); then odd shapes at a batch off the block size ((Lq, Lr) =
     (1, 1), (7, 5), (20, 192), (150, 192), (161, 192), and (1024, 1024)
     with match 1).  Then the sw_align_batch composition (two kernel
     passes) against the same composition over the twin at the flat
     window's shapes (B = 32768, Lq = Lr = 160): three parameter sets,
     planted pairs, all-N rows.  All outputs must be exactly equal; both
     sides are timed with CUDA events, and each time is printed with its
     cells, GCUPS and share of its bound: 8.5 int32 instructions per cell
     over the SMs' dispatch rate (SMs x 128 lanes x clocks.max.sm).
  4. cuda vs cpu: a small FASTA DB, taxonomy and paired FASTQ made from
     --seed, run by the port's CLI on cuda and on cpu: classification;
     --sam-file on paired reads; --just-align --sam-file on single-end
     reads; --device-pipeline off --sam-file; --host-screen (a table
     built by --build-host-table from one genome) with
     --low-complexity-cutoff; and a run that crashes after chunk 2 and is
     finished with --resume.  Every output (SAM without @PG) must be
     byte-identical between the devices, every cuda run must launch the
     kernel, and the resumed run must equal an uninterrupted one.
  5. real size: the 1.6 Gbp synthetic DB of the reference package's
     bench (16 genomes x 100 Mbp, ~1e8 stride-16 index k-mers) and
     262,144 planted 150 bp reads (131,072 pairs, 1% mutations) through
     the CLI on cuda; >= 99% of the pairs must get their genome's taxid.
     Prints the kernel's launches and DP cells on this path and the
     cells per second over the phase_a_sw stage.
  6. real-size SAM: phase 5's DB and reads with --sam-file on cuda;
     >= 99% of the planted pairs must have their R1 primary line on the
     planted genome within 5 of the planted position.
  7. host-object path: --device-pipeline off on phase 5's DB with the
     first --host-pairs pairs (its pairing is Python); >= 99% of the
     pairs classified, with kernel launches through sw_align_batch.
  8. real-size mesh: phase 5's DB and reads with --mesh 2x2
     --shard-genomes on cuda (every cell on the visible cards, cycled);
     the XML, _PerRead and _abbreviated files must be byte-identical to
     phase 5's.  Prints the stage seconds (shard_placement: sharding and
     placing the DB), the peak memory of every device, the mesh cells on
     each device, and the kernel's launches and DP cells on this path.
Phase 4 also runs, on cuda, --mesh 2x2 (classification), --mesh 1x4
--shard-genomes --sam-file, and two processes of --coordinator
localhost:PORT --num-processes 2 sharing the card; each must launch the
kernel and write what the single-device CPU run wrote (the two-process
SAM compared as one header and its body lines sorted).
The line before the last is a JSON object describing each kernel, the
last line the contract object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import collections
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after one
    warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# int32 instructions a DP cell needs at least with Hopper's DPX forms:
# score byte permute 1, h' = max(diag + s, E, 0) 1, H = max(h', F) 1,
# F' and E' 2 each (a subtract, then an add-max), the key's shift-add 1
# and half of a three-way max over two keys
OPS_PER_CELL = 8.5
DISPATCH_LANES_PER_SM = 128  # thread-instructions an SM dispatches a clock
MEMORY_BYTES_PER_S = 3.35e12


def sm_clock_mhz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(res.stdout.strip().splitlines()[0].split()[0])


def sw_bound(cells: int, nbytes: int):
    """(bound ms, what bounds it): the larger of OPS_PER_CELL
    instructions per cell at the SMs' dispatch rate (4 schedulers x 32
    lanes per clock at clocks.max.sm) and the bytes over the memory
    rate."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_mhz() * 1e6
    ops_ms = OPS_PER_CELL * cells / (sms * DISPATCH_LANES_PER_SM * clock) \
        * 1e3
    bytes_ms = nbytes / MEMORY_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def timing_line(name: str, ms: float, plain_ms: float, cells: int,
                nbytes: int):
    bound_ms, bound_by = sw_bound(cells, nbytes)
    log(f"  timing {name}: kernel {ms:.3f} ms, {cells} cells "
        f"({cells / ms / 1e6:.1f} GCUPS); bound {bound_ms:.3f} ms "
        f"({bound_by}), {bound_ms / ms:.1%} of it; plain {plain_ms:.3f} ms")
    return bound_ms, bound_by


def sass_step_loop(lib_path: str, rows: int):
    """The step loop of sw_group_kernel<rows, int8 scores> in the built
    library's SASS (cuobjdump): the shortest backward-branch loop that
    holds PRMT, as (instruction count, opcode counts); None without
    cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    for func in sass.split("Function : ")[1:]:
        if f"sw_group_kernelILi{rows}ELb1E" not in func.split("\n", 1)[0]:
            continue
        ins = [(int(a, 16), op.strip()) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        loops = []
        for addr, op in ins:
            m = re.search(r"BRA\S*\s+(?:\S+, )?(0x[0-9a-f]+)", op)
            if m and int(m.group(1), 16) < addr:
                body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
                if any("PRMT" in o for o in body):
                    loops.append(body)
        if loops:
            body = min(loops, key=len)
            return len(body), collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", o).split()[0] for o in body)
    return None


def max_abs_err(a, b) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if len(x) else 0 for x, y in zip(a, b))


def phase_kernel(rng, dev):
    """Kernel vs plain twin at the main path's shapes and odd shapes;
    returns (max_abs_err, kernel ms, plain ms, (bound ms, bound_by))."""
    from kslam_tpu_torch.ops import sw, sw_cuda
    b, lq, lr = 32768, 160, 192
    worst = 0

    def check(name, q, r, params, n_valid=None):
        nonlocal worst
        qd, rd = torch.as_tensor(q, device=dev), torch.as_tensor(r, device=dev)
        nv = None if n_valid is None else torch.tensor(n_valid, device=dev,
                                                       dtype=torch.int32)
        got = sw_cuda.sw_forward_batch(qd, rd, *params, n_valid=nv)
        ref = sw_cuda.sw_forward_batch_plain(qd, rd, *params, n_valid=nv)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        worst = max(worst, err)
        log(f"  {name} params={params}: max_abs_err={err} "
            f"mean score={float(got.score.float().mean()):.2f}")
        if err != 0:
            raise AssertionError(f"kernel != plain on {name} {params}")

    def codes(n_frac=0.05, shape=(b, lq)):
        x = rng.integers(0, 4, shape).astype(np.int32)
        x[rng.random(shape) < n_frac] = 4
        return x

    for params in ((2, 3, 5, 2), (1, 4, 6, 1), (3, 2, 2, 2)):
        check("random 5% N", codes(), codes(shape=(b, lr)), params)
    q = rng.integers(0, 4, (b, lq)).astype(np.int32)
    r = rng.integers(0, 4, (b, lr)).astype(np.int32)
    off = rng.integers(0, lr - lq + 1, b)
    cols = off[:, None] + np.arange(lq)[None, :]
    planted = q.copy()
    mut = rng.random((b, lq)) < 0.02
    planted[mut] = rng.integers(0, 4, int(mut.sum()))
    np.put_along_axis(r, cols, planted, axis=1)
    check("planted near-identical", q, r, (2, 3, 5, 2))
    q_n = q.copy()
    q_n[::7] = 4
    check("all-N rows", q_n, r, (2, 3, 5, 2))
    cfg = sw_cuda.launch_config(b, lq, lr)
    off_block = 37 * (cfg.threads // cfg.group) + 5
    for nv in (0, 1, b - 1000, off_block):
        check(f"n_valid={nv}", q, r, (2, 3, 5, 2), n_valid=nv)

    # once through the window builder (both passes), on a small genome
    g = rng.integers(0, 4, 200_000).astype(np.uint8)
    offsets = np.array([0, 120_000, 200_000], np.int64)
    chunks = sw.genome_chunks_from_scodes(g)
    read_id = rng.integers(0, 4096, b).astype(np.int32)
    entry = rng.integers(0, 2, b).astype(np.int32)
    rel = rng.integers(-20, 79_000, b).astype(np.int32)
    rcf = rng.random(b) < 0.5
    reads = codes(0.01, (4096, lq)).astype(np.uint8)
    lens = rng.integers(100, lq + 1, 4096).astype(np.int32)
    args = [torch.as_tensor(x, device=dev) for x in
            (read_id, entry, rel, rcf, np.ones(b, bool), reads, lens,
             chunks, offsets)]
    got = sw.align_overlaps_batch_chunked(*args, 2, 3, 5, 2, window_len=lq)
    launches = sw_cuda.LAUNCHES
    sw_fwd = sw_cuda.sw_forward_batch
    try:
        sw_cuda.sw_forward_batch = sw_cuda.sw_forward_batch_plain
        ref = sw.align_overlaps_batch_chunked(*args, 2, 3, 5, 2,
                                              window_len=lq)
    finally:
        sw_cuda.sw_forward_batch = sw_fwd
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    worst = max(worst, err)
    log(f"  align_overlaps_batch_chunked (forward + reverse pass): "
        f"max_abs_err={err}, {sw_cuda.LAUNCHES - launches} launches on the "
        f"plain run")
    if err != 0 or sw_cuda.LAUNCHES != launches:
        raise AssertionError("chunked alignment: kernel != plain")

    # odd shapes: query rows padded to the group's, tiny refs, the
    # largest shape; a batch that is not a multiple of the block
    ob = 4099
    for olq, olr in ((1, 1), (7, 5), (20, 192), (150, 192), (161, 192)):
        for params in ((2, 3, 5, 2), (1, 4, 6, 1), (3, 2, 2, 2)):
            check(f"Lq={olq} Lr={olr} B={ob}", codes(shape=(ob, olq)),
                  codes(shape=(ob, olr)), params)
    check(f"Lq=1024 Lr=1024 B={ob}", codes(shape=(ob, 1024)),
          codes(shape=(ob, 1024)), (1, 4, 6, 1))

    qd = torch.as_tensor(codes(), device=dev)
    rd = torch.as_tensor(codes(shape=(b, lr)), device=dev)
    ms = cuda_ms(lambda: sw_cuda.sw_forward_batch(qd, rd, 2, 3, 5, 2), 20)
    plain_ms = cuda_ms(
        lambda: sw_cuda.sw_forward_batch_plain(qd, rd, 2, 3, 5, 2), 3)
    nbytes = (qd.numel() * qd.element_size() + rd.numel() * rd.element_size()
              + 12 * b)
    bound = timing_line(
        f"sw_forward B={b} Lq={lq} Lr={lr} ({cfg.group} threads x "
        f"{cfg.rows} rows per alignment)", ms, plain_ms, b * lq * lr, nbytes)
    return worst, ms, plain_ms, bound


def phase_align(rng, dev):
    """sw_align_batch (two kernel passes) vs the same composition over
    the plain twin at the flat window's shapes; returns (max_abs_err,
    kernel ms, plain ms, (bound ms, bound_by))."""
    from kslam_tpu_torch.ops import sw_cuda
    b, l = 32768, 160
    worst = 0

    def check(name, q, r, params):
        nonlocal worst
        qd, rd = torch.as_tensor(q, device=dev), torch.as_tensor(r, device=dev)
        got = sw_cuda.sw_align_batch(qd, rd, *params)
        ref = sw_cuda.sw_align_batch_plain(qd, rd, *params)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        worst = max(worst, err)
        log(f"  sw_align_batch {name} params={params}: max_abs_err={err} "
            f"mean score={float(got.score.float().mean()):.2f}")
        if err != 0:
            raise AssertionError(f"sw_align_batch != plain on {name}")

    q = rng.integers(0, 4, (b, l)).astype(np.int32)
    planted = q.copy()
    mut = rng.random((b, l)) < 0.02
    planted[mut] = rng.integers(0, 4, int(mut.sum()))
    shift = rng.integers(0, 20, b)[:, None]
    src = np.arange(l)[None, :] - shift
    r = np.where(src >= 0, np.take_along_axis(planted, np.maximum(src, 0),
                                              axis=1),
                 rng.integers(0, 4, (b, l))).astype(np.int32)
    q[::7] = 4                                       # all-N rows
    for params in ((2, 3, 5, 2), (1, 4, 6, 1), (3, 2, 2, 2)):
        check("planted pairs, all-N rows", q, r, params)
    noise = rng.integers(0, 4, (b, l)).astype(np.int32)
    noise[rng.random((b, l)) < 0.05] = 4
    check("random 5% N", noise, r, (2, 3, 5, 2))
    qd, rd = torch.as_tensor(q, device=dev), torch.as_tensor(r, device=dev)
    ms = cuda_ms(lambda: sw_cuda.sw_align_batch(qd, rd, 2, 3, 5, 2), 20)
    plain_ms = cuda_ms(
        lambda: sw_cuda.sw_align_batch_plain(qd, rd, 2, 3, 5, 2), 3)
    # two passes; the codes in once, five int32 outputs per row
    nbytes = 2 * qd.numel() * qd.element_size() + 20 * b
    bound = timing_line(
        f"sw_align_batch B={b} Lq=Lr={l} (two passes)", ms, plain_ms,
        2 * b * l * l, nbytes)
    return worst, ms, plain_ms, bound


def write_taxonomy(path: str, taxids) -> None:
    from kslam_tpu_torch.db.taxonomy import TaxonomyDB
    tax = TaxonomyDB()
    tax.parent_of[1], tax.rank_of[1], tax.name_of[1] = 1, "no rank", "root"
    tax.parent_of[2], tax.rank_of[2], tax.name_of[2] = \
        1, "superkingdom", "Bacteria"
    for t in taxids:
        tax.parent_of[t], tax.rank_of[t], tax.name_of[t] = \
            2, "species", f"species {t}"
    tax.write_index(path)


def plant_pairs(rng, genomes, n_pairs: int, read_len: int = 150,
                mut_rate: float = 0.01):
    """Paired reads planted from random genomes: R1 forward at pos, R2
    the reverse complement at pos + insert - read_len.  Returns
    (r1 u8 [n, L], r2 u8 [n, L], genome index [n], R1 position [n])."""
    comp = np.zeros(256, np.uint8)
    for a, c in zip(b"ACGT", b"TGCA"):
        comp[a] = c
    bases4 = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, len(genomes), n_pairs)
    at = np.zeros(n_pairs, np.int64)
    r1 = np.empty((n_pairs, read_len), np.uint8)
    r2 = np.empty((n_pairs, read_len), np.uint8)
    for k, gen in enumerate(genomes):
        sel = np.flatnonzero(g == k)
        ins = rng.integers(2 * read_len, 2 * read_len + 200, len(sel))
        pos = rng.integers(0, len(gen) - 2 * read_len - 200, len(sel))
        idx = np.arange(read_len)[None, :]
        at[sel] = pos
        r1[sel] = gen[pos[:, None] + idx]
        r2[sel] = comp[gen[(pos + ins - read_len)[:, None] + idx]][:, ::-1]
    for block in (r1, r2):
        m = rng.random(block.shape) < mut_rate
        block[m] = bases4[rng.integers(0, 4, int(m.sum()))]
    return r1, r2, g, at


def write_fastq(path: str, names, seqs) -> None:
    qual = b"I" * seqs.shape[1]
    with open(path, "wb") as fh:
        for name, s in zip(names, seqs):
            fh.write(b"@" + name + b"\n" + s.tobytes() + b"\n+\n" + qual +
                     b"\n")


def build_db(root: str, genomes, taxids) -> float:
    """DB directory (genomes.npz + meta.json + kmer_index.npz + taxDB) in
    the reference package's format; returns host build seconds."""
    from kslam_tpu_torch.config import GENOME_KMER_GAP
    from kslam_tpu_torch.db.genbank import GenbankEntry, GenbankIndex
    from kslam_tpu_torch.db.kmer_index import KmerIndex
    from kslam_tpu_torch.ops import kmers
    t0 = time.perf_counter()
    gindex = GenbankIndex([GenbankEntry(bases="", taxonomy_id=int(t),
                                        locus_tag=f"G{i}")
                           for i, t in enumerate(taxids)])
    gindex._bases_concat = np.concatenate(genomes)
    gindex._offsets = np.zeros(len(genomes) + 1, np.int64)
    gindex._offsets[1:] = np.cumsum([len(g) for g in genomes])
    parts = [kmers.sequence_kmers_np(g, GENOME_KMER_GAP) for g in genomes]
    km = np.concatenate([p[0] for p in parts])
    eid = np.concatenate([np.full(len(p[0]), i, np.int32)
                          for i, p in enumerate(parts)])
    off = np.concatenate([p[1] for p in parts])
    rc = np.concatenate([p[2] for p in parts])
    del parts
    # KmerIndex.build's order: k-mer asc, ties by (rc, entry, offset) desc
    tie = ((rc.astype(np.uint64) << np.uint64(62)) |
           (eid.astype(np.uint64) << np.uint64(31)) | off.astype(np.uint64))
    order = np.lexsort((~tie, km))
    del tie
    kidx = KmerIndex(km[order], eid[order], off[order], rc[order])
    del km, eid, off, rc, order
    gindex.save(root)
    kidx.save(root)
    write_taxonomy(os.path.join(root, "taxDB"), taxids)
    return time.perf_counter() - t0


def run_cli(db: str, out: str, r1: str, r2, device: str,
            flags=()) -> float:
    """One port CLI run (r2 None: single-end); returns its wall seconds."""
    from kslam_tpu_torch import cli
    t0 = time.perf_counter()
    rc = cli.main(["--db", db, "--output-file", out, "--device", device,
                   *flags, r1] + ([r2] if r2 else []))
    if device == "cuda":
        torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"CLI exited {rc}")
    return time.perf_counter() - t0


def read_outputs(out: str, sam: bool):
    """The files a run wrote: the SAM without @PG (the command line),
    then XML, _PerRead and _abbreviated where present."""
    files = []
    if sam:
        with open(out + ".sam", "rb") as fh:
            files.append(b"".join(line for line in fh
                                  if not line.startswith(b"@PG")))
    for suf in ("", "_PerRead", "_abbreviated"):
        if os.path.exists(out + suf):
            with open(out + suf, "rb") as fh:
                files.append(fh.read())
    return files


def compare_devices(tmp: str, db: str, name: str, r1: str, r2, flags,
                    sam: bool):
    """The same CLI run on cpu and on cuda: outputs byte-identical, the
    kernel launched on cuda only.  Returns the cuda run's files."""
    from kslam_tpu_torch.ops import sw_cuda
    outs = {}
    for device in ("cpu", "cuda"):
        out = os.path.join(tmp, f"small_{name}_{device}")
        extra = list(flags) + (["--sam-file", out + ".sam"] if sam else [])
        before = sw_cuda.LAUNCHES
        secs = run_cli(db, out, r1, r2, device, extra)
        launched = sw_cuda.LAUNCHES - before
        outs[device] = read_outputs(out, sam)
        log(f"  {name} {device}: {secs:.2f} s, {launched} SW kernel "
            f"launches")
        if (launched > 0) != (device == "cuda"):
            raise AssertionError(f"{name}: {launched} SW launches on "
                                 f"{device}")
    sizes = [len(x) for x in outs["cuda"]]
    same = outs["cpu"] == outs["cuda"]
    log(f"  {name}: outputs byte-identical between cuda and cpu: {same} "
        f"(bytes {sizes})")
    if not same or not sizes or min(sizes) == 0:
        raise AssertionError(f"{name}: cuda and cpu outputs differ or are "
                             f"empty")
    return outs["cuda"]


def run_mesh_cuda(tmp: str, db: str, name: str, r1: str, r2, flags,
                  sam: bool, want) -> int:
    """One CLI run on cuda with mesh flags; its files must equal `want`
    (the single-device runs' files).  Returns its kernel launches."""
    from kslam_tpu_torch.ops import sw_cuda
    out = os.path.join(tmp, f"small_{name}_cuda")
    extra = list(flags) + (["--sam-file", out + ".sam"] if sam else [])
    sw_cuda.LAUNCHES = 0
    secs = run_cli(db, out, r1, r2, "cuda", extra)
    launched = sw_cuda.LAUNCHES
    same = read_outputs(out, sam) == want
    log(f"  {name} cuda: {secs:.2f} s, {launched} SW kernel launches; "
        f"outputs byte-identical to the single-device CPU run: {same}")
    if not same or launched == 0:
        raise AssertionError(f"{name}: outputs differ or no SW launch")
    return launched


# a port CLI process that reports its kernel launches on stdout
_CLI_PROCESS = (
    "import sys\n"
    "from kslam_tpu_torch import cli\n"
    "from kslam_tpu_torch.ops import sw_cuda\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print('sw_forward launches', sw_cuda.LAUNCHES, flush=True)\n"
    "sys.exit(rc)\n")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_two_processes(tmp: str, db: str, r1: str, r2, flags, want,
                      name: str = "small_two_process_cuda",
                      visible=None) -> int:
    """--coordinator localhost:PORT --num-processes 2 on cuda; returns
    the processes' kernel launches.  visible: each process's
    CUDA_VISIBLE_DEVICES (None: both see every card).  The outputs must
    equal `want` ([SAM without @PG, XML, _PerRead, _abbreviated]), the
    SAM as one header and its sorted body lines."""
    out = os.path.join(tmp, name)
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CLI_PROCESS, "--db", db, "--output-file",
         out, "--sam-file", out + ".sam", "--device", "cuda", *flags,
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(pid), r1, r2], cwd=root,
        env=dict(os.environ, PYTHONPATH=root,
                 **({} if visible is None else
                    {"CUDA_VISIBLE_DEVICES": visible[pid]})),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=300))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    secs = time.perf_counter() - t0
    launches = []
    for pid, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        m = re.search(r"sw_forward launches (\d+)", stdout)
        if p.returncode != 0 or m is None:
            raise AssertionError(f"process {pid} exited {p.returncode}:\n"
                                 f"{stderr[-3000:]}")
        launches.append(int(m.group(1)))

    def split_sam(text: bytes):
        lines = text.splitlines(keepends=True)
        return ([x for x in lines if x.startswith(b"@")],
                sorted(x for x in lines if not x.startswith(b"@")))
    got = read_outputs(out, sam=True)
    same = split_sam(got[0]) == split_sam(want[0]) and got[1:] == want[1:]
    parts_left = [f for f in os.listdir(tmp)
                  if f.startswith(f"{name}.sam.part")]
    log(f"  two processes (--coordinator, gloo) on cuda"
        + ("" if visible is None else f", cards {visible}")
        + f": {secs:.2f} s, SW kernel launches {launches}; SAM (one "
        f"header, sorted body) and XML/TSV equal to the single-device run: "
        f"{same}")
    if not same or min(launches) == 0 or parts_left:
        raise AssertionError("the two-process run differs, left SAM parts "
                             "or launched no SW kernel in a process")
    return sum(launches)


class SimulatedCrash(Exception):
    pass


def phase_e2e_small(rng, tmp: str) -> None:
    from kslam_tpu_torch import cli
    from kslam_tpu_torch.pipeline import run as run_mod
    genomes = [np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 20_000)]
               for _ in range(4)]
    taxids = [10, 11, 12, 13]
    db = os.path.join(tmp, "small_db")
    build_db(db, genomes, taxids)
    r1, r2, _, _ = plant_pairs(rng, genomes, 600)
    names = [f"s{i}".encode() for i in range(len(r1))]
    s1, s2 = os.path.join(tmp, "s1.fq"), os.path.join(tmp, "s2.fq")
    write_fastq(s1, names, r1)
    write_fastq(s2, names, r2)
    plain = compare_devices(tmp, db, "classify", s1, s2, [], sam=False)
    sam = compare_devices(tmp, db, "sam", s1, s2, [], sam=True)
    launches = {"mesh_2x2": run_mesh_cuda(
        tmp, db, "mesh_2x2", s1, s2, ["--mesh", "2x2"], False, plain)}
    launches["mesh_1x4_shard_genomes_sam"] = run_mesh_cuda(
        tmp, db, "mesh_1x4_shard_genomes_sam", s1, s2,
        ["--mesh", "1x4", "--shard-genomes"], True, sam)
    compare_devices(tmp, db, "just_align_single_end", s1, None,
                    ["--just-align"], sam=True)
    compare_devices(tmp, db, "host_path", s1, s2,
                    ["--device-pipeline", "off"], sam=True)

    # host screen: a table of genome 0 (taxid 10) from --build-host-table
    host_fa = os.path.join(tmp, "host.fa")
    with open(host_fa, "wb") as fh:
        fh.write(b">G0\n" + genomes[0].tobytes() + b"\n")
    host_dir = os.path.join(tmp, "host_table")
    if cli.main(["--build-host-table", "--output-file", host_dir,
                 host_fa]) != 0:
        raise AssertionError("--build-host-table failed")
    screened = compare_devices(
        tmp, db, "host_screen", s1, s2,
        ["--host-screen", host_dir, "--low-complexity-cutoff", "40"],
        sam=False)

    def n_taxid(per_read: bytes, taxid: int) -> int:
        return sum(line.endswith(b"\t%d" % taxid)
                   for line in per_read.split(b"\n"))
    before, after = n_taxid(plain[1], 10), n_taxid(screened[1], 10)
    log(f"  host screen: reads of the host's taxid {before} -> {after}")
    # reads with mutations may keep too short a host chain (the reference's
    # cutoffs), so most, not all, host pairs go
    if before == 0 or after > before // 2:
        raise AssertionError("the host screen removed too few host reads")

    # crash in chunk 3 of 3, then --resume; equal to an uninterrupted run
    flags = ["--num-reads-at-once", "200", "--resume"]
    full = compare_devices(tmp, db, "resume_uninterrupted", s1, s2, flags,
                           sam=True)
    # three chunks of 200 pairs: process 0 takes chunks 0 and 2, process 1
    # chunk 1
    launches["two_process"] = run_two_processes(
        tmp, db, s1, s2, ["--num-reads-at-once", "200"], full)
    out = os.path.join(tmp, "small_resumed_cuda")
    flags = flags + ["--sam-file", out + ".sam"]
    real = run_mod.process_chunk
    calls = [0]

    def crashing(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 3:
            raise SimulatedCrash("simulated crash in chunk 3")
        return real(*args, **kwargs)

    run_mod.process_chunk = crashing
    try:
        run_cli(db, out, s1, s2, "cuda", flags)
        raise AssertionError("the simulated crash did not happen")
    except SimulatedCrash:
        pass
    finally:
        run_mod.process_chunk = real
    if not os.path.exists(out + ".cursor.json"):
        raise AssertionError("no checkpoint after the crash")
    run_cli(db, out, s1, s2, "cuda", flags)
    same = read_outputs(out, sam=True) == full
    log(f"  resume: crashed in chunk 3, resumed; equal to the "
        f"uninterrupted run: {same}")
    if not same or os.path.exists(out + ".cursor.json"):
        raise AssertionError("the resumed run differs from an "
                             "uninterrupted one")
    return launches


def phase_real(rng, tmp: str, mbp: int, n_pairs: int):
    """The real-size run; returns (the SW launch count of the main path,
    the DB, reads and planted truth for phases 6 and 7)."""
    from kslam_tpu_torch.ops import sw_cuda
    from kslam_tpu_torch.utils import metrics
    n_genomes = 16
    glen = mbp * 1_000_000 // n_genomes
    t0 = time.perf_counter()
    genomes = [np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, glen, dtype=np.uint8)] for _ in range(n_genomes)]
    taxids = [100 + i for i in range(n_genomes)]
    db = os.path.join(tmp, "real_db")
    gen_s = time.perf_counter() - t0
    build_s = build_db(db, genomes, taxids)
    r1, r2, g, at = plant_pairs(rng, genomes, n_pairs)
    del genomes
    names = [f"r{i}".encode() for i in range(n_pairs)]
    write_fastq(os.path.join(tmp, "r1.fq"), names, r1)
    write_fastq(os.path.join(tmp, "r2.fq"), names, r2)
    del r1, r2
    log(f"  DB {n_genomes} x {glen / 1e6:.1f} Mbp: genomes {gen_s:.1f} s, "
        f"host DB build + save {build_s:.1f} s")

    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    sw_cuda.LAUNCHES = sw_cuda.LAUNCH_CELLS = 0
    out = os.path.join(tmp, "real_out")
    wall = run_cli(db, out, os.path.join(tmp, "r1.fq"),
                   os.path.join(tmp, "r2.fq"), "cuda")
    launches, cells = sw_cuda.LAUNCHES, sw_cuda.LAUNCH_CELLS
    peak = torch.cuda.max_memory_allocated()
    stages = metrics.summary()
    per_read = dict(line.split("\t") for line in
                    open(out + "_PerRead").read().strip().split("\n"))
    hits = sum(per_read.get(f"r{i}") == str(taxids[k])
               for i, k in enumerate(g.tolist()))
    frac = hits / n_pairs
    n_reads = 2 * n_pairs
    loop_s = wall - stages.get("db_load", {}).get("seconds", 0.0)
    log(f"  classification: {n_reads} reads, CLI wall {wall:.2f} s "
        f"({n_reads / wall * 60:.0f} reads/min), without the DB load "
        f"{loop_s:.2f} s ({n_reads / loop_s * 60:.0f} reads/min)")
    log(f"  stages: {json.dumps(stages)}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated), SW launches {launches}")
    sw_s = stages.get("phase_a_sw", {}).get("seconds", 0.0)
    log(f"  SW kernel on the main path: {launches} launches, {cells} DP "
        f"cells; phase_a_sw {sw_s:.3f} s, "
        f"{cells / sw_s / 1e9 if sw_s else 0.0:.1f} G cells/s over the "
        f"stage (window building and the reverse pass's gathers included)")
    log(f"  pairs classified to their genome's taxid: {hits}/{n_pairs} "
        f"({frac:.4%})")
    if frac < 0.99:
        raise AssertionError(f"only {frac:.4%} of planted pairs classified")
    if launches == 0:
        raise AssertionError("the main path launched no SW kernel")
    return launches, cells, dict(db=db, r1=os.path.join(tmp, "r1.fq"),
                          r2=os.path.join(tmp, "r2.fq"), g=g, at=at,
                          taxids=taxids, out=out)


def phase_sam(ctx, tmp: str):
    """--sam-file at real size; returns the SW launch count of the run."""
    from kslam_tpu_torch.ops import sw_cuda
    from kslam_tpu_torch.utils import metrics
    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    sw_cuda.LAUNCHES = 0
    out = os.path.join(tmp, "real_sam")
    wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                   ["--sam-file", out + ".sam"])
    launches = sw_cuda.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stages = metrics.summary()
    first = {}            # read name -> (RNAME, POS) of its R1 primary line
    n_lines = 0
    with open(out + ".sam") as fh:
        for line in fh:
            if line.startswith("@"):
                continue
            n_lines += 1
            f = line.split("\t", 4)
            flag = int(f[1])
            if flag & 0x40 and not flag & 0x100 and f[0] not in first:
                first[f[0]] = (f[2], int(f[3]))
    g, at = ctx["g"], ctx["at"]
    hits = 0
    for i in range(len(g)):
        rname, pos = first.get(f"r{i}", ("*", 0))
        hits += rname == f"G{g[i]}" and abs(pos - (int(at[i]) + 1)) <= 5
    frac = hits / len(g)
    n_reads = 2 * len(g)
    sec = {k: round(stages.get(k, {}).get("seconds", 0.0), 3)
           for k in ("db_load", "to_host_pairs", "sam_output")}
    log(f"  SAM run: {n_reads} reads, CLI wall {wall:.2f} s "
        f"({n_reads / wall * 60:.0f} reads/min), {n_lines} SAM lines; "
        f"stage seconds {json.dumps(sec)}")
    log(f"  stages: {json.dumps(stages)}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB, SW launches "
        f"{launches}")
    log(f"  R1 primary lines on the planted genome within 5 of the "
        f"planted position: {hits}/{len(g)} ({frac:.4%})")
    if frac < 0.99:
        raise AssertionError(f"only {frac:.4%} of SAM lines placed right")
    if launches == 0:
        raise AssertionError("the SAM path launched no SW kernel")
    return launches


def phase_host_path(ctx, tmp: str, n_pairs: int):
    """--device-pipeline off on the first n_pairs pairs; returns (SW
    launches, launches through sw_align_batch)."""
    from kslam_tpu_torch.ops import sw_cuda
    from kslam_tpu_torch.utils import metrics
    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = 0
    out = os.path.join(tmp, "real_host_path")
    wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                   ["--device-pipeline", "off", "--num-reads", str(n_pairs)])
    launches, through_align = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    stages = metrics.summary()
    per_read = dict(line.split("\t") for line in
                    open(out + "_PerRead").read().strip().split("\n"))
    g, taxids = ctx["g"][:n_pairs], ctx["taxids"]
    hits = sum(per_read.get(f"r{i}") == str(taxids[k])
               for i, k in enumerate(g.tolist()))
    frac = hits / n_pairs
    n_reads = 2 * n_pairs
    log(f"  host-object path: {n_reads} reads, CLI wall {wall:.2f} s "
        f"({n_reads / wall * 60:.0f} reads/min)")
    log(f"  stages: {json.dumps(stages)}")
    log(f"  peak device memory {peak / 2**30:.2f} GiB, SW launches "
        f"{launches}, of which through sw_align_batch {through_align}")
    log(f"  pairs classified to their genome's taxid: {hits}/{n_pairs} "
        f"({frac:.4%})")
    if frac < 0.99:
        raise AssertionError(f"only {frac:.4%} of pairs classified")
    if through_align == 0 or through_align != launches:
        raise AssertionError("the host-object path did not launch the "
                             "kernel through sw_align_batch")
    return launches, through_align


def phase_mesh(ctx, tmp: str, shape: str = "2x2"):
    """--mesh SHAPE --shard-genomes at real size, its cells cycled over
    the visible cards; returns (SW launches, DP cells) of the run."""
    from kslam_tpu_torch.ops import sw_cuda
    from kslam_tpu_torch.parallel import dist
    from kslam_tpu_torch.utils import metrics
    d_axis, s_axis = (int(x) for x in shape.split("x"))
    mesh = dist.build_mesh(dist.local_devices("cuda"), data=d_axis,
                           index=s_axis)
    devs = mesh.distinct()
    metrics.reset()
    for dev in devs:
        torch.cuda.reset_peak_memory_stats(dev)
    sw_cuda.LAUNCHES = sw_cuda.LAUNCH_CELLS = 0
    out = os.path.join(tmp, f"real_mesh_{shape}")
    wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                   ["--mesh", shape, "--shard-genomes"])
    launches, cells = sw_cuda.LAUNCHES, sw_cuda.LAUNCH_CELLS
    peaks = {str(d): torch.cuda.max_memory_allocated(d) for d in devs}
    stages = metrics.summary()
    same = read_outputs(out, sam=False) == read_outputs(ctx["out"],
                                                         sam=False)
    n_reads = 2 * len(ctx["g"])
    load_s = sum(stages.get(k, {}).get("seconds", 0.0)
                 for k in ("db_load", "shard_placement"))
    per_dev = collections.Counter(str(d) for row in mesh.devices
                                  for d in row)
    sec = {k: stages[k]["seconds"] for k in (
        "db_load", "shard_placement", "pack_reads", "phase_a", "mesh_join",
        "mesh_merge", "mesh_sw", "mesh_gather_back", "mesh_pair",
        "insert_model", "phase_b", "taxonomy", "write_results")
        if k in stages}
    log(f"  mesh {shape} run: {n_reads} reads, CLI wall {wall:.2f} s "
        f"({n_reads / wall * 60:.0f} reads/min), without the DB load and "
        f"placement {wall - load_s:.2f} s "
        f"({n_reads / (wall - load_s) * 60:.0f} reads/min)")
    log(f"  stage seconds {json.dumps(sec)}")
    log(f"  stages: {json.dumps(stages)}")
    log(f"  mesh cells per device {dict(per_dev)}; peak device memory "
        + ", ".join(f"{d} {b / 2**30:.2f} GiB" for d, b in peaks.items())
        + " (torch.cuda.max_memory_allocated)")
    log(f"  SW kernel on the mesh path: {launches} launches, {cells} DP "
        f"cells; mesh_sw {sec.get('mesh_sw', 0.0):.3f} s")
    log(f"  XML, _PerRead, _abbreviated byte-identical to phase 5: {same}")
    if not same:
        raise AssertionError("the mesh run's outputs differ from phase 5")
    if launches == 0:
        raise AssertionError("the mesh path launched no SW kernel")
    return launches, cells


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mbp", type=int, default=1600,
                    help="size of the real-size DB (16 genomes)")
    ap.add_argument("--pairs", type=int, default=131072,
                    help="read pairs of the real-size run")
    ap.add_argument("--host-pairs", type=int, default=16384,
                    help="read pairs of the host-object path run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from kslam_tpu_torch.io import native
    from kslam_tpu_torch.ops import sw_cuda

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"phase 1 device: {name}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        sw_build = pool.submit(sw_cuda.load_library)
        host_build = pool.submit(native.get_lib)
        sw_build.result()
        host_lib = host_build.result()
    log(f"phase 2 build: SW kernel and native host library built in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for line in sw_cuda.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    rows = sw_cuda.launch_config(32768, 160, 192).rows
    loop = sass_step_loop(sw_cuda.load_library()._name, rows)
    if loop is None:
        log("  SASS instructions per cell: not measured (no cuobjdump)")
    else:
        log(f"  SASS step loop of the main path's kernel (R={rows}): "
            f"{loop[0]} instructions for {rows} cells, "
            f"{loop[0] / rows:.2f} per cell; {dict(loop[1].most_common())}")
    log(f"  native host library: {native.BUILD_REPORT}")
    if host_lib is None:
        raise AssertionError("the native host library is absent: "
                             f"{native.BUILD_REPORT}")

    rng = np.random.default_rng(args.seed)
    log("phase 3 kernel vs plain twin on the card")
    err, ms, plain_ms, bound = phase_kernel(rng, dev)
    # a generator of its own: phases 4-5 draw their data from rng alone
    a_err, a_ms, a_plain_ms, a_bound = phase_align(
        np.random.default_rng(args.seed + 1), dev)

    with tempfile.TemporaryDirectory(prefix="kslam_smoke_") as tmp:
        log("phase 4 CLI cuda vs cpu on a small DB")
        small_launches = phase_e2e_small(rng, tmp)
        log(f"phase 5 real size: {args.mbp} Mbp DB, {args.pairs} pairs")
        launches, cells, ctx = phase_real(rng, tmp, args.mbp, args.pairs)
        log(f"phase 6 real-size SAM: {args.pairs} pairs")
        sam_launches = phase_sam(ctx, tmp)
        log(f"phase 7 host-object path (--device-pipeline off): "
            f"{args.host_pairs} pairs")
        if args.host_pairs < args.pairs:
            log(f"  depth cut: {args.host_pairs} of the {args.pairs} pairs "
                f"(the host-object pairing is Python)")
        flat_launches, align_launches = phase_host_path(
            ctx, tmp, min(args.host_pairs, args.pairs))
        log(f"phase 8 real-size mesh (--mesh 2x2 --shard-genomes): "
            f"{args.pairs} pairs")
        mesh_launches, mesh_cells = phase_mesh(ctx, tmp)

    kernels = {"kernels": [{
        "name": "sw_forward", "route": "cuda",
        "source": "kslam_tpu_torch/csrc/sw_forward.cu",
        "replaces": "kslam_tpu/ops/sw_pallas.py:163",
        "launches": launches,
        "launches_by_path": {"device_pipeline": launches,
                             "sam": sam_launches,
                             "flat_window": flat_launches,
                             "mesh_2x2_shard_genomes": mesh_launches,
                             **{f"small_{k}": v
                                for k, v in small_launches.items()}},
        "cells_main_path": cells, "cells_mesh_path": mesh_cells,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1],
        "bound_share": bound[0] / ms, "library_ms": None}, {
        "name": "sw_align_batch", "route": "cuda",
        "source": "kslam_tpu_torch/ops/sw_cuda.py",
        "replaces": "kslam_tpu/ops/sw_pallas.py:188",
        "launches": align_launches,
        "max_abs_err": a_err, "ms": a_ms, "plain_ms": a_plain_ms,
        "bound_ms": a_bound[0], "bound_by": a_bound[1],
        "bound_share": a_bound[0] / a_ms, "library_ms": None}]}
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
