"""Chip smoke test of the PyTorch/CUDA port (kslam_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N] [--mbp 1600] [--pairs 131072]
                          [--host-pairs 16384]

Phases (each prints its own line; any failure exits non-zero):
  1. device: the card's name and power limit; a CUDA device is required.
  2. build: the CUDA kernel library (ops/cuda_lib.py: one nvcc per
     kslam_tpu_torch/csrc/*.cu, all started together, linked into one
     library: the SW kernels, the join's sector_join, bucket_join
     and window_join, and the SAM path's sam_cigar and sam_diff;
     ptxas's registers and spills of every kernel are printed) and the
     native host library (make -C csrc, the first of $CXX, g++, c++ that
     links OpenMP), built in parallel; both must load.
  3. kernels vs plain: the forward kernel (sw_forward) against its
     plain torch twin on the card at the main path's shapes (B = 32768,
     Lq = 160, Lr = 192): random codes with 5% N, planted near-identical
     pairs, all-N rows, n_valid of 0, 1, B - 1000 and one off the block
     size, three scoring parameter sets; odd shapes at a batch off the
     block size ((Lq, Lr) = (1, 1), (7, 5), (20, 192), (150, 192),
     (161, 192), and (1024, 1024) with match 1); once through
     align_overlaps_batch_chunked on random candidates (the fused
     kernel; the draws keep phases 4-8's data).  Then the fused forward
     + reverse kernel (sw_align) against its plain version (the
     composition over the twin): the flat window's shapes (B = 32768,
     Lq = Lr = 160; planted pairs, every 7th query all N, three
     parameter sets; random 5% N; leading, trailing and middle N runs
     with n_valid of 0, 1, B - 1 and one off the block size), odd shapes,
     the device pipeline's chunked windows (Lq = 160, Lr = 192) of
     planted candidates on a uniform genome and of candidates on
     realistic genomes (kslam_tpu_torch.eval.realistic: repeat copies
     and low-complexity tracts), and once through
     align_overlaps_batch_chunked.  All outputs must be exactly equal.
     Timed with CUDA events: the forward kernel and its twin; at the flat
     and the chunked shapes the fused kernel against the two-launch
     composition in turns (old, new, new, old) and the plain version.
     Each time is printed with its share of the bound of the cells these
     inputs need (forward: the query's rows up to its last base x the
     ref's columns from its first to its last base; reverse: rows up to
     query_end x columns from the first base to ref_end): 8.5 int32
     instructions per cell over the SMs' dispatch rate (SMs x 128 lanes
     x clocks.max.sm); the cells the fused kernel computes and the
     rectangle's are printed beside them.  Then the join kernels against
     their plain versions on every query (lo, hi, uncovered):
     sector_join on indexes whose sector tables (2^16 and 2^21 rows,
     each built on the card and equal bit for bit to the CPU's build)
     have rows of every count 0..6, both kinds of escape and the edge
     words, and on a 2^12-row table where most queries escape;
     bucket_join on an index with bucket rows of every count 0..8, both
     kinds of escape and the edge words; window_join at windows 8 to 128
     with an uncovered run, at 4 to 128 on long runs and real all-ones
     keys, and on a mesh shard's collapsed prefixes; 1, 255 and 257
     queries; and match.join_bounds through each kernel (one launch)
     equal to the plain lookup + tier 2 for q_ok all, none and a random
     half.  Then the SAM path's kernels on a synthetic mix of 32,768
     alignments, richer in indels and clipped windows than phase 6's
     planted reads (eval/sam_cases: reads of 150 bp copied from 8
     entries of 250 kbp, forward and rc, 30% with indels, 5% with an
     insertion and a deletion of 3-6 bases, 5% at an entry's end or
     before its start, 5% with N, lowercase or a short length; phase A's
     ends moved for a tenth): sam_cigar equal to its plain version on
     the card's tensors and to native.ssw_cigar_batch on the host,
     sam_diff equal to its plain version, both again on 8,192 alignments
     on tandem repeats (the tie-break decides every end); each timed in
     turns (plain, kernel, kernel, plain) with its bound: sam_cigar's DP
     cells (the forward and reverse passes, the banded DP's attempts) at
     8.5 int32 instructions a cell over the SMs' dispatch rate,
     sam_diff's bytes at 3.35 TB/s beside the floor of its serial
     float64 chain (the longest walk x the add's latency, measured by a
     clock64 probe this script builds, x rounds of the alignments the
     kernel's occupancy holds in flight); sam_cigar's time split by
     torch.profiler between its passes kernel and its band kernel (the
     first launch and the relaunch; listed as sam_band, with its own
     plain time and bound); and sam_cigar_long, the path for reads past
     the group kernel's key, on 256 reads of 1,100 bases: launched,
     equal to its plain version, timed in turns.
  4. cuda vs cpu: a small FASTA DB, taxonomy and paired FASTQ made from
     --seed, run by the port's CLI on cuda and on cpu: classification;
     --sam-file on paired reads; --just-align --sam-file on single-end
     reads; --device-pipeline off --sam-file; --host-screen (a table
     built by --build-host-table from one genome) with
     --low-complexity-cutoff; and a run that crashes after chunk 2 and is
     finished with --resume.  Every output (SAM without @PG) must be
     byte-identical between the devices, every cuda run must launch the
     kernel, and the resumed run must equal an uninterrupted one.
     Phases 4-10 also count each path's join kernel launches (reset just
     before the run, read just after): every path on the card must join
     through the kernel of its table (sector_join with the sector table
     DeviceDB builds at load; window_join on a mesh and with
     --no-prefix-rows) and launch no other; the cpu runs launch none.
     Every SAM run on the card (here, in phase 6 and phase 8) must
     launch sam_cigar and sam_diff, the cpu runs no SAM kernel.
  5. real size: the 1.6 Gbp synthetic DB of the reference package's
     bench (16 genomes x 100 Mbp, ~1e8 stride-16 index k-mers) and
     262,144 planted 150 bp reads (131,072 pairs, 1% mutations) through
     the CLI on cuda; >= 99% of the pairs must get their genome's taxid.
     Every CLI run here and below builds the sector table on the card at
     load (DeviceDB.from_index) and joins with it and its exact tier 2;
     phases 5-9 print db_load split into the three files (taxonomy,
     genomes, k-mer index), the host arrays, the staged H2D copies, the
     columns derived on the card (db/device_columns.py), the table's
     build and the rest, and the peak device memory at the load's end
     and over the run.  The columns the run's load derived on the card
     (keys, idx_pack, pstart, bits, window, genome rows) must equal, bit
     for bit, the host versions (join_columns, sw_codes_np,
     genome_chunks_from_scodes) run once on the index the run loaded.
     Every SW launch must be a fused sw_align launch (4 at the default
     size, one per batch of 32,768 candidates); prints the launches and
     rectangle cells on this path and the cells per second over the
     phase_a_sw stage.
  6. real-size SAM: phase 5's DB and reads with --sam-file on cuda;
     >= 99% of the planted pairs must have their R1 primary line on the
     planted genome within 5 of the planted position.  The run must
     launch sam_cigar, sam_band and sam_diff (counts reset just before it, read
     just after) and call none of native.ssw_cigar_batch,
     compute_cigars_batch, get_cigar_and_md or the kernels' plain
     versions; prints sam_output beside the host cigars' 48.783 s.
     Then, on the host: the run's sam_cigar columns equal to native.ssw_cigar_batch
     on every alignment, its CIGAR, MD, NM and prob equal to the copied
     get_cigar_and_md on >= 20,000 alignments (every one with an indel
     or a soft clip among them), and the SAM lines of those alignments'
     reads equal to the copied _fill_cigars + write_sam_pairs.
  7. host-object path: --device-pipeline off on phase 5's DB with the
     first --host-pairs pairs (its pairing is Python); >= 99% of the
     pairs classified, every SW launch a fused sw_align launch.
  8. real-size mesh: phase 5's DB and reads with --mesh 2x2
     --shard-genomes on cuda (every cell on the visible cards, cycled);
     the XML, _PerRead and _abbreviated files must be byte-identical to
     phase 5's.  Prints the stage seconds (shard_placement: the shards
     and genome slices derived on the card), the peak memory of every
     device, the mesh cells on each device, and the kernel's launches
     and rectangle cells on this path; every launch fused, 4 at the
     default size.  Every placed shard and genome slice must equal, bit
     for bit, shard_database(..., with_prefix=True) + index_words_np and
     genome_chunks_from_scodes over shard_genomes on the loaded index.
     Then the same run with --sam-file: it must launch both SAM kernels
     and window_join, its SAM (without @PG) must be byte-identical to
     phase 6's and its other files to phase 5's.
  9. chunk pipeline: phase 5's DB and reads in 4 chunks of a quarter
     of --pairs each (one device batch each at the default size)
     through the CLI on cuda, --no-chunk-overlap (depth 1) and the
     default (depth 3) in turns, three runs each (1, 3, 3, 1, 1, 3):
     XML, _PerRead and _abbreviated byte-identical across the
     runs, >= 99% of pairs
     classified, every SW launch fused; each run prints its wall, its
     wall without db_load, reads/min both ways, its stage seconds and its
     peak device memory, which must not pass phase 5's.  Then one run at each depth under torch.profiler
     (CPU and CUDA activities): the device's busy share, the union of
     the kernel, memcpy and memset intervals over the run's chunk_loop
     span ("not measured" with the reason when the trace has none).
     Then kslam_tpu_torch.eval.comparison on the runs' _PerRead against
     the planted truth: its species-correct count must equal the run's
     own count, and McNemar between depths 1 and 3 must find 0
     discordant reads.
 10. join kernels: phase 5's DB and the k-mers of all its reads at
     once (31.7 M query positions at the default size): the reference's
     bucket table built on the host (timed, not cached), the sector
     table built on the card (timed) and on the CPU, equal bit for bit;
     sector_join (lookup_sector), bucket_join (lookup_bucket) and
     window_join (lookup_prefix_window) must equal
     their plain versions on every query, and ops/match.join_bounds
     through each (one launch, tier 2 inside) the exact search
     (searchsorted_both, the library call) on every kept query and the
     plain lookup + tier 2 and the unfused composition (the kernel,
     then torch.nonzero, searchsorted_both and index_put) on every
     query.  Every call (exact search; each kernel, its plain version,
     join_bounds, the composition and the plain lookup + tier 2) is
     timed with CUDA events in turns (the order, then reversed, three
     times): ms, peak device memory over the call, each call's bytes
     bound (the keys, the distinct table rows, or the distinct pstart
     entries and run keys the queries read, tier 2's distinct keys, the
     outputs; beside it window_join's two-row bound, which counts the
     two rows around each run) and share, and the share of kept
     queries sent to tier 2; the sector join_bounds under
     set_sync_debug_mode("error").  The sector table also at 2^(L-2),
     2^(L-1) and 2^L rows (L = ceil(log2 keys)): each built on the card
     (timed), checked as above, its join_bounds timed in the same turns,
     with its bytes bound (32 B rows) and tier-2 share, and the smallest
     size within the fastest one's spread printed beside
     sector_table.default_bits.  Then a repeat-rich index (>= 1e7 keys
     from eval/realistic genomes, built in the run, and the k-mers of
     reads copied from them; >= 1% of kept queries to tier 2 with the
     bucket table; its columns and genome rows derived on the card equal
     to join_columns and the host rows bit for bit): the same checks and
     timings, the sector table also at 2^25-2^27 rows.  Then one --no-prefix-rows
     CLI run on cuda (window_join on the path), byte-identical to phase
     5's.  Its numbers are printed as one {"join": ...} line.
 11. DB provisioning: a local NCBI mirror (eval/ncbi_mirror, written by
     spawned processes) of 64 bacterial assemblies built from
     eval/realistic's pieces (chromosomes over 1-8 Mbp, median ~4 Mbp,
     one of 10 Mbp; the shared plasmid on every third; ~0.86 genes a kbp;
     species in 8 genera under Bacteria; ~284 Mbp) and three rows the
     installer must skip (a replaced assembly, a scaffold, no ftp_path);
     kslam_tpu_torch.install_db.main(--bacteria) in-process with fetch
     bound to the mirror, twice: each stage's seconds (taxonomy fetch +
     extract, genome fetch + gunzip, --parse-taxonomy, the GBFF parse,
     the index build + save, the total), exactly the complete, latest
     assemblies fetched, then 0 fetches and the same DB files (an .npz
     member by member).  The reference's parser (db/genbank) against the
     linear one (db/gbff) on one-genome GBFFs of 1, 2 and 4 Mbp in turns:
     equal entries, both times.  Then 32,768 pairs planted from the
     chromosomes (by length) through the CLI on cuda on the installed
     DB: stages, db_load's split, the card-derived columns equal to the
     host versions, reads/min, peak, the sector_join and fused sw_align
     launches, >= 99% of pairs to their genome's taxid
     or genus, gene hits in the XML; and the first 512 pairs on cpu and
     on cuda, byte-identical.  Its numbers are printed as one
     {"install": ...} line.
Phase 4 also runs, on cuda, --mesh 2x2 (classification), --mesh 1x4
--shard-genomes --sam-file, and two processes of --coordinator
localhost:PORT --num-processes 2 sharing the card; and three chunks of
200 pairs with --sam-file (cpu and cuda at depth 3, cuda at depth 1) and
with --mesh 2x2 on cuda at both depths, against the cpu run of the same
chunks.  Each must launch the kernel and write what the single-device
CPU run wrote (the two-process SAM compared as one header and its body
lines sorted).
The last three lines are the card's name and power limit (nvidia-smi),
a JSON object describing each kernel (the SW kernels, the three
join kernels and the two SAM kernels, each with its launches on its
paths, phase 11's as "installed_db"), and the contract object
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
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

from kslam_tpu_torch.eval.sw_windows import column_extents, n_windows


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


def needed_cells(q, r, n_valid=None, al=None):
    """The cells these inputs need (data-dependent work; numpy inputs):
    the forward pass (last non-N query row + 1) x (c1 - c0 + 1) per live
    row, 0 for an all-N query or ref (N rows past the query's last base
    and N columns outside c0..c1 can at most tie a cell the tie-break
    prefers); with al (the alignments), the reverse pass (query_end + 1)
    x (ref_end - c0 + 1) per row with score > 0.  Returns (forward,
    reverse)."""
    b = q.shape[0]
    c0, c1 = column_extents(r)
    _, q1 = column_extents(q)
    live = np.arange(b) < (b if n_valid is None else int(n_valid))
    fwd = int(((q1 + 1) * np.maximum(c1 - c0 + 1, 0) * live).sum())
    if al is None:
        return fwd, 0
    rev = (al.query_end.astype(np.int64) + 1) * \
        (al.ref_end.astype(np.int64) - c0 + 1)
    return fwd, int(np.where(al.score > 0, rev, 0).sum())


def computed_cells(r, al, group: int, rows: int, n_valid=None):
    """The cells the fused kernel computes (numpy inputs): G * R rows x
    (c1 - c0 + 1) columns forward per live row, and ceil((query_end + 1)
    / R) * R rows x (ref_end - c0 + 1) columns reverse per row with
    score > 0.  Returns (forward, reverse)."""
    b = r.shape[0]
    c0, c1 = column_extents(r)
    live = np.arange(b) < (b if n_valid is None else int(n_valid))
    fwd = int((group * rows * np.maximum(c1 - c0 + 1, 0) * live).sum())
    lanes = (al.query_end.astype(np.int64) + rows) // rows
    rev = lanes * rows * (al.ref_end.astype(np.int64) - c0 + 1)
    return fwd, int(np.where(al.score > 0, rev, 0).sum())


def trip_columns(r, al):
    """Columns each row's group of the fused kernel sweeps (numpy): c1 -
    c0 + 1 forward, ref_end - c0 + 1 reverse where the score is > 0."""
    c0, c1 = column_extents(r)
    rev = np.where(al.score > 0, al.ref_end.astype(np.int64) - c0 + 1, 0)
    return np.maximum(c1 - c0 + 1, 0) + rev


def timing_line(name: str, ms: float, plain_ms: float, cells: int,
                nbytes: int):
    bound_ms, bound_by = sw_bound(cells, nbytes)
    log(f"  timing {name}: kernel {ms:.3f} ms, {cells} cells needed "
        f"({cells / ms / 1e6:.1f} GCUPS); bound {bound_ms:.3f} ms "
        f"({bound_by}), {bound_ms / ms:.1%} of it; plain {plain_ms:.3f} ms")
    return bound_ms, bound_by


def time_in_turns(old, new, iters: int):
    """old, new, new, old: the mean ms of each over its two turns, and
    the four readings."""
    o1 = cuda_ms(old, iters)
    n1 = cuda_ms(new, iters)
    n2 = cuda_ms(new, iters)
    o2 = cuda_ms(old, iters)
    return (o1 + o2) / 2, (n1 + n2) / 2, [o1, n1, n2, o2]


def sass_step_loops(lib_path: str, rows: int, align: bool):
    """The step loops of sw_group_kernel<rows, int8 scores, align> in the
    built library's SASS (cuobjdump): the backward-branch loops that hold
    PRMT (the forward kernel has one, the fused kernel one per pass), as
    [(instruction count, opcode counts)], shortest first; None without
    cuobjdump."""
    from torch.utils.cpp_extension import CUDA_HOME
    tool = os.path.join(CUDA_HOME or "", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    name = f"sw_group_kernelILi{rows}ELb1ELb{int(align)}E"
    for func in sass.split("Function : ")[1:]:
        if name not in func.split("\n", 1)[0]:
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
        # the shortest: the step loop (one per pass of the fused kernel)
        loops.sort(key=len)
        return [(len(body), collections.Counter(
            re.sub(r"^@!?U?P\w+\s+", "", o).split()[0] for o in body))
            for body in loops[:2 if align else 1]]
    return None


def ptxas_report(build_log: str):
    """[(kernel, "Used N registers ...; ... spill ...")] from nvcc's
    -Xptxas -v output, one entry per compiled kernel."""
    out, func = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            func = m.group(1)
            out.append([func, []])
        elif func and ("registers" in line or "spill" in line):
            out[-1][1].append(line.split(":", 1)[-1].strip())
    return [(f, "; ".join(info)) for f, info in out]


def max_abs_err(a, b) -> int:
    return max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
               if len(x) else 0 for x, y in zip(a, b))


def phase_kernel(rng, dev, b: int = 32768):
    """The forward kernel vs its plain twin at the main path's shapes and
    odd shapes, and once the window builder through the fused kernel;
    returns (max_abs_err, kernel ms, plain ms, (bound ms, bound_by))."""
    from kslam_tpu_torch.ops import sw, sw_cuda
    lq, lr = 160, 192
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
        log(f"  sw_forward {name} params={params}: max_abs_err={err} "
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

    # once through the window builder (the fused kernel) on random
    # candidates of a small genome, against it over the plain version
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
    kernel = sw_cuda.sw_align_batch
    try:
        sw_cuda.sw_align_batch = sw_cuda.sw_align_batch_plain
        ref = sw.align_overlaps_batch_chunked(*args, 2, 3, 5, 2,
                                              window_len=lq)
    finally:
        sw_cuda.sw_align_batch = kernel
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    worst = max(worst, err)
    log(f"  align_overlaps_batch_chunked on random candidates: "
        f"max_abs_err={err}, {sw_cuda.LAUNCHES - launches} launches on "
        f"the plain run")
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
    cells, _ = needed_cells(qd.cpu().numpy(), rd.cpu().numpy())
    log(f"  sw_forward cells: {cells} needed of {b * lq * lr} in the "
        f"rectangle (the forward kernel computes the rectangle)")
    bound = timing_line(
        f"sw_forward B={b} Lq={lq} Lr={lr} ({cfg.group} threads x "
        f"{cfg.rows} rows per alignment)", ms, plain_ms, cells, nbytes)
    return worst, ms, plain_ms, bound


def phase_join_kernels(rng, dev) -> None:
    """The join kernels against their plain versions on the card, on
    every query, beside phase 10's full-size run: sector_join on indexes
    whose tables (2^16 and 2^21 rows) have rows of every count 0..6, both
    kinds of escape and the edge words, and on a 2^12-row table where
    most queries escape, each table built on the card and equal to the
    CPU's bit for bit; bucket_join on an index whose table has rows of
    every count 0..8, both kinds of escape and the edge words;
    window_join at w = 8 to 128 with an uncovered run, and at w = 4 to
    128 on runs at the run-only read's edges (a
    long run of 3w + 1 keys, real all-ones keys before the sentinels, the
    zero word) and on a mesh shard's collapsed prefixes; query counts 1,
    255 and 257 (off the block).  Each lookup (lo, hi, uncovered) must
    equal the plain version's, and match.join_bounds through its kernel
    (one launch, tier 2 inside) the plain lookup + tier 2 on every query
    for q_ok all, none and a random half."""
    from kslam_tpu_torch.db import sector_table
    from kslam_tpu_torch.db.kmer_index import KmerIndex
    from kslam_tpu_torch.eval import join_cases
    from kslam_tpu_torch.ops import join, join_cuda, kmers, match
    words = join_cases.bucket_index_words(rng)
    z = np.zeros(len(words), np.int32)
    tbl, bits = KmerIndex(words, z, z, np.zeros(len(words), bool)) \
        .bucket_table()
    d_tbl = torch.from_numpy(tbl).to(dev)
    b_keys = torch.as_tensor(kmers.keys_from_words_np(
        join_cases.sentinel_padded(words, 16))).to(dev)
    cases = [("bucket_join", words, b_keys, lambda q: (
        join.lookup_bucket(d_tbl, q, bits),
        join.lookup_bucket_plain(d_tbl, q, bits)),
        dict(idx_bucket=d_tbl, bucket_bits=bits))]
    few = np.sort(np.concatenate([
        rng.integers(0, 2**64 - 1, 50_000, dtype=np.uint64),
        join_cases.EDGES, np.full(300, join_cases.EDGES[7])]))
    for name, s_words, s_bits in (
            ("sector_join 2^16 rows", join_cases.sector_index_words(
                rng, bits=16), 16),
            ("sector_join 2^21 rows", join_cases.sector_index_words(
                rng, bits=21), 21),
            ("sector_join 2^12 rows (most escape)", few, 12)):
        keys = torch.as_tensor(kmers.keys_from_words_np(
            join_cases.sentinel_padded(s_words, 16)))
        s_tbl = sector_table.build(keys.to(dev), len(s_words), s_bits)
        if not torch.equal(s_tbl.cpu(), sector_table.build(
                keys, len(s_words), s_bits)):
            raise AssertionError(f"{name}: the table built on the card "
                                 f"differs from the CPU's")
        cases.append((name, s_words, keys.to(dev), lambda q, t=s_tbl,
                      b=s_bits: (join.lookup_sector(t, q, b),
                                 join.lookup_sector_plain(t, q, b)),
                      dict(idx_sector=s_tbl, sector_bits=s_bits)))
        log(f"  {name}: the table built on the card equals the CPU's "
            f"bit for bit")
    tables = [(f"window_join w={w}", b, w,
               join_cases.prefix_index_words(rng, b, w))
              for b, w in ((10, 8), (8, 16), (9, 32), (10, 64), (12, 128))]
    tables += [(f"window_join w={w} edge runs", b, w,
                join_cases.run_edge_words(rng, b, w))
               for b, w in ((8, 4), (8, 8), (8, 16), (7, 32), (6, 64),
                            (6, 128))]
    km, _, pstart = join_cases.run_edge_words(rng, 8, 16)
    tables.append(("window_join w=16 shard", 8, 16, (km, *join_cases
                   .prefix_shard(km, pstart, len(km) // 3,
                                 2 * len(km) // 3, 16))))
    for name, pbits, window, (km, padded, pstart) in tables:
        keys = torch.as_tensor(kmers.keys_from_words_np(padded)).to(dev)
        d_pstart = torch.as_tensor(pstart).to(dev)
        cases.append((name, km, keys, lambda q, k=keys, p=d_pstart,
                      b=pbits, w=window: (
            join.lookup_prefix_window(k, p, q, b, w),
            join.lookup_prefix_window_plain(k, p, q, b, w)),
            dict(idx_pstart=d_pstart, prefix_bits=pbits, window=window)))
    for name, index_words, keys, run, kw in cases:
        q_all = torch.as_tensor(kmers.keys_from_words_np(
            join_cases.queries_for(index_words, rng))).to(dev)
        for n in (q_all.numel(), 1, 255, 257):
            before = sum(join_cuda.JOIN_LAUNCHES.values())
            got, plain = run(q_all[:n])
            torch.cuda.synchronize()
            launched = sum(join_cuda.JOIN_LAUNCHES.values()) - before
            err = max_abs_err(got, plain)
            if err or launched != 1:
                raise AssertionError(f"{name}, {n} queries: max abs err "
                                     f"{err}, {launched} launches")
            if n == q_all.numel():
                uncovered = int((got[2] > 0).sum())
        n = q_all.numel()
        masks = {"all": torch.ones(n, dtype=torch.bool, device=dev),
                 "none": torch.zeros(n, dtype=torch.bool, device=dev),
                 "random": torch.as_tensor(rng.random(n) < 0.5).to(dev)}
        for mask, q_ok in masks.items():
            before = sum(join_cuda.JOIN_LAUNCHES.values())
            got = match.join_bounds(q_all, q_ok, keys, **kw)
            torch.cuda.synchronize()
            launched = sum(join_cuda.JOIN_LAUNCHES.values()) - before
            want = match.tier2(*run(q_all)[1], q_all, q_ok, keys)
            err = max_abs_err(got, want)
            if err or launched != 1:
                raise AssertionError(f"{name} join_bounds, q_ok {mask}: max "
                                     f"abs err {err}, {launched} launches")
        log(f"  {name}: equal to the plain version on all {n} queries "
            f"({uncovered} uncovered) and at 1, 255, 257 queries; "
            f"join_bounds (one launch) equal to the plain lookup + tier 2 "
            f"for q_ok all, none and a random half")


# --- the SAM path's kernels (sam_cigar, sam_diff) ---

SW_DEFAULT = (2, 3, 5, 2)     # SWParams(): match, mismatch, gap_open, extend
SAM_KEYS = ("score", "ref_begin", "ref_end", "query_begin", "query_end",
            "cigar_len")


def band_cells(read_sub, ref_n, w0, w1) -> int:
    """Cells of the banded DP's attempts at w0, 2 w0, ..., w1 (numpy; one
    row an alignment)."""
    total = 0
    if len(w0) == 0:
        return 0
    w = w0.astype(np.int64).copy()
    live = np.ones(len(w), bool)
    i = np.arange(int(read_sub.max()))[None, :]
    while live.any():
        beg = np.maximum(i - w[:, None], 0)
        end = np.minimum(i + w[:, None], ref_n[:, None] - 1)
        cells = np.clip(end - beg + 1, 0, None) * (i < read_sub[:, None])
        total += int(cells[live].sum())
        live &= w < w1
        w = np.where(live, w * 2, w)
    return total


def sam_cigar_work(c, win_len, ref_start, out, bands):
    """(cells, bytes) sam_cigar needs on these alignments: the forward
    pass m x wlen, the reverse pass (query_end + 1) x (ref_end + 1) in
    the window's own coordinates, the banded DP's attempts (from the
    plain version's bands); the reads, windows and columns in, the
    columns and runs out, each once."""
    m = c["lengths"][c["read_id"]].astype(np.int64)
    w = win_len.astype(np.int64)
    rc = c["rc"].astype(bool)
    rb = out["ref_begin"].astype(np.int64) - ref_start
    re = out["ref_end"].astype(np.int64) - ref_start
    qb, qe = (out[k].astype(np.int64) for k in ("query_begin", "query_end"))
    re_w = np.where(rc, w - 1 - rb, re)
    qe_w = np.where(rc, m - 1 - qb, qe)
    rev = np.where((re_w >= 0) & (m > 0), (qe_w + 1) * (re_w + 1), 0)
    cells = int((m * w).sum() + rev.sum())
    for read_len, ref_len, w0, w1 in bands:
        cells += band_cells(read_len, ref_len, w0, w1)
    runs = np.clip(out["cigar_len"], 0, None).astype(np.int64)
    nbytes = int(m.sum() + w.sum() + 256 + 17 * len(m) + 24 * len(m)
                 + 4 * runs.sum())
    return cells, nbytes


def band_cells_and_bytes(c, bands, cigar_len):
    """(cells, bytes) sam_cigar's band kernel needs on these alignments:
    the banded DP's attempts (from the plain version's bands); the
    sub-reads and sub-windows, the SW code table and the columns it reads
    (score, four ends, read_id, rc, ref_start, wlen, the read's length)
    in, cigar_len and the runs out, each once."""
    cells = sum(band_cells(r, f, w0, w1) for r, f, w0, w1 in bands)
    sub = sum(int(r.sum()) + int(f.sum()) for r, f, _, _ in bands)
    runs = np.clip(cigar_len, 0, None).astype(np.int64)
    return cells, sub + 256 + 44 * len(c["read_id"]) + 4 * int(runs.sum())


def sam_diff_bytes(c, out, dlen, cigar_len) -> int:
    """Bytes sam_diff needs on these alignments, each once: the reads and
    qualities, the window bytes its walks read, the columns and runs in;
    the texts and columns out."""
    m = c["lengths"][c["read_id"]].astype(np.int64)
    runs = np.clip(cigar_len, 0, None).astype(np.int64)
    window = np.minimum(out["ref_need"], dlen).astype(np.int64)
    return int(2 * m.sum() + window.sum() + 25 * len(m) + 4 * runs.sum()
               + 1600 + out["cigar_n"].astype(np.int64).sum()
               + out["md_n"].astype(np.int64).sum() + 24 * len(m))


def timed_once(fn, n: int = 1):
    """(fn()'s last result, mean ms of n calls by CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        res = fn()
    stop.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(stop) / n


def turns(plain_ms: float, plain, kernel, iters: int):
    """plain, kernel, kernel, plain by CUDA events: the first plain turn
    is plain_ms (the call that was checked), the kernel's turns the mean
    over iters calls after a warm-up call.  Returns the plain and kernel
    means and the four readings."""
    kernel()
    k1 = timed_once(kernel, iters)[1]
    k2 = timed_once(kernel, iters)[1]
    p2 = timed_once(plain)[1]
    return (plain_ms + p2) / 2, (k1 + k2) / 2, [plain_ms, k1, k2, p2]


def cigar_columns_equal(got, want) -> bool:
    """sam_cigar's columns and live runs equal between two results."""
    width = int(want["cigar_len"].max())
    return all(torch.equal(got[k].cpu(), want[k].cpu()) for k in SAM_KEYS) \
        and torch.equal(got["cigar_buf"][:, :width].cpu(),
                        want["cigar_buf"][:, :width].cpu())


DADD_PROBE = r"""
extern "C" __global__ void dadd_chain(long long* cycles, double* x, int n) {
  double v = x[0];
  const double d = x[1];
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) v = __dadd_rn(v, d);
  const long long t1 = clock64();
  x[2] = v;
  cycles[0] = t1 - t0;
}
extern "C" int dadd_cycles(long long* cycles, double* x, int n) {
  dadd_chain<<<1, 1>>>(cycles, x, n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


def dadd_latency_cycles(n: int = 1 << 16) -> float:
    """Cycles of one dependent float64 add on this card: one thread, a
    chain of n __dadd_rn timed by clock64 (DADD_PROBE, built here with
    nvcc into a temporary directory)."""
    import ctypes
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    tmp = tempfile.mkdtemp(prefix="kslam_dadd_")
    try:
        src, lib = os.path.join(tmp, "dadd.cu"), os.path.join(tmp, "dadd.so")
        with open(src, "w") as fh:
            fh.write(DADD_PROBE)
        subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                        "-Xcompiler", "-fPIC", src, "-o", lib],
                       check=True, capture_output=True, timeout=300)
        probe = ctypes.CDLL(lib)
        dev = torch.device("cuda")
        cycles = torch.zeros(1, dtype=torch.int64, device=dev)
        x = torch.tensor([1.0, 1e-9, 0.0], dtype=torch.float64, device=dev)
        torch.cuda.synchronize()
        for _ in range(2):                  # the second call: a warm clock
            err = probe.dadd_cycles(ctypes.c_void_p(cycles.data_ptr()),
                                    ctypes.c_void_p(x.data_ptr()),
                                    ctypes.c_int(n))
            if err:
                raise RuntimeError(f"dadd probe failed: cudaError {err}")
        return int(cycles.item()) / n
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def diff_in_flight(stride: int, dwin_stride: int, cap: int) -> int:
    """The alignments sam_diff holds in flight on the card: one lane
    each, a warp a block, its blocks resident on each SM as its shared
    memory (csrc/sam.cu's kslam_sam_diff: the tables, the text lengths,
    the queued MD calls, then a slot a lane) and its registers (ptxas's,
    from this run's build) allow."""
    from kslam_tpu_torch.ops import cuda_lib
    r16 = lambda v: -(-v // 16) * 16            # noqa: E731
    slot = 2 * r16(min(stride, 1024)) + r16(min(dwin_stride, 1024)) + \
        2 * r16(min(cap, 256))
    smem = 2 * 100 * 8 + 256 + 2 * 32 * 4 + 32 * 32 * 4 + 32 * slot
    regs = [int(m.group(1)) for f, info in ptxas_report(cuda_lib.BUILD_LOG)
            if "sam_diff_kernel" in f
            for m in [re.search(r"Used (\d+) registers", info)] if m]
    per_warp = -(-(regs[0] if regs else 0) * 32 // 256) * 256
    blocks = min(32, 64, 233472 // (smem + 1024),
                 65536 // per_warp if per_warp else 64)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * blocks * 32


def kernel_device_ms(fn, iters: int) -> dict:
    """Mean device ms a call of fn() of each CUDA kernel it launches, by
    name: the kernels' own intervals in a torch.profiler trace of iters
    calls (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory(prefix="kslam_prof_") as tmp:
        trace = os.path.join(tmp, "calls.trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(trace)
        with open(trace) as fh:
            events = json.load(fh).get("traceEvents", [])
    out = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel":
            out[e["name"]] += e.get("dur", 0) / 1e3 / iters
    if not out:
        raise AssertionError("the profiler's trace holds no CUDA kernel")
    return dict(out)


def named_ms(times: dict, part: str) -> float:
    """The ms of the kernels whose names hold `part`."""
    return sum(v for k, v in times.items() if part in k)


def walk_bases(cigar_buf, cigar_len) -> np.ndarray:
    """The M bases of each alignment's walk: the terms of its float64
    chain (numpy)."""
    width = max(int(cigar_len.max()), 1)
    runs = np.asarray(cigar_buf)[:, :width].astype(np.int64)
    live = np.arange(width)[None, :] < np.asarray(cigar_len)[:, None]
    return np.where(live & ((runs & 15) == 0), runs >> 4, 0).sum(1)


def phase_sam_kernels(rng, dev, n: int = 32768):
    """sam_cigar and sam_diff on a synthetic mix of n alignments
    (eval/sam_cases: forward and rc, 30% with indels, 5% with a
    shifted middle, 5% at an entry's end or before its start, 5% with N,
    lowercase or a short length; phase A's ends moved for a tenth):
    each equal to its plain version on the card's tensors, sam_cigar
    also to the native host call; both again on the tie-heavy tandem
    mix; timed in turns, sam_cigar's time split by torch.profiler
    between its passes kernel and its band kernel (sam_band's line);
    sam_diff's serial float64 floor beside its bytes bound;
    sam_cigar_long on reads of 1,100 bases.  Returns their kernels line
    entries."""
    from kslam_tpu_torch.config import SWParams
    from kslam_tpu_torch.eval import sam_cases
    from kslam_tpu_torch.io import native
    from kslam_tpu_torch.ops import sam_cuda
    t0 = time.perf_counter()
    c = sam_cases.alignments(rng, sam_cases.entries(rng, 8, 250_000), n)
    max_ops = sam_cuda.native_max_ops(c["lengths"])
    ops = sam_cases.cigar_operands(c, dev)
    log(f"  SAM alignments: {n} drawn in {time.perf_counter() - t0:.1f} s "
        f"({int(c['rc'].sum())} rc, {int((c['rel_pos'] < 0).sum())} with "
        f"rel_pos < 0)")
    stride, width = ops[0].shape[1], ops[4].shape[1]
    cfg = sam_cuda.cigar_config(n, stride, width)
    log(f"  sam_cigar passes launch: {cfg}; band kernel: 8 lanes an "
        f"alignment, region {sam_cuda.band_region(stride, sam_cuda.W_CAP)}"
        f" B (W_CAP {sam_cuda.W_CAP}); group kernels take the batch: "
        f"{sam_cuda.takes_group(stride, width, SW_DEFAULT)}")
    got = sam_cuda.sam_cigar(*ops, SW_DEFAULT, 0, max_ops)
    torch.cuda.synchronize()
    bands = []
    band_plain_s = []
    real = sam_cuda.banded_cigar_plain

    def record(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = real(*args, **kwargs)
        torch.cuda.synchronize()
        band_plain_s.append(time.perf_counter() - t)
        bands.append(tuple(x.cpu().numpy() for x in
                           (args[1], args[3], args[5], res[2])))
        return res
    sam_cuda.banded_cigar_plain = record
    try:
        plain, cigar_plain_ms = timed_once(
            lambda: sam_cuda.sam_cigar_plain(*ops, SW_DEFAULT, 0, max_ops))
    finally:
        sam_cuda.banded_cigar_plain = real
    width = int(plain["cigar_len"].max())
    g = {k: got[k].cpu().numpy() for k in SAM_KEYS}
    p = {k: plain[k].cpu().numpy() for k in SAM_KEYS}
    nat = native.ssw_cigar_batch(c["reads"], c["lengths"], c["bases"],
                                 c["offsets"], c["read_id"], c["entry_id"],
                                 c["rel_pos"], c["rc"],
                                 SWParams(), score_filter=0)
    gbuf = got["cigar_buf"][:, :width].cpu().numpy()
    same_plain = cigar_columns_equal(got, plain)
    nbuf = np.where(np.arange(width)[None, :] < nat["cigar_len"][:, None],
                    nat["cigar_buf"][:, :width], 0)
    same_native = all(np.array_equal(g[k], nat[k]) for k in SAM_KEYS) and \
        np.array_equal(np.where(np.arange(width)[None, :] <
                                g["cigar_len"][:, None], gbuf, 0), nbuf)
    err = max(int(np.abs(g[k].astype(np.int64) - p[k]).max())
              for k in SAM_KEYS)
    runs = g["cigar_len"]
    w_final = np.concatenate([b[3] for b in bands]) if bands else \
        np.zeros(0)
    w_first = np.concatenate([b[2] for b in bands]) if bands else \
        np.zeros(0)
    log(f"  sam_cigar vs its plain version: equal {same_plain}, max abs "
        f"err {err}; vs native.ssw_cigar_batch on the host: equal "
        f"{same_native}; runs up to {width}, aborted "
        f"{int((runs == sam_cuda.ABORTED).sum())}, bands doubled at least "
        f"twice {int((w_final >= 4 * np.maximum(w_first, 1)).sum())}, "
        f"wider than the shared-memory region (W_CAP {sam_cuda.W_CAP}: "
        f"relaunched with a device slab) "
        f"{int((w_final > sam_cuda.W_CAP).sum())}")
    if not (same_plain and same_native):
        raise AssertionError("sam_cigar differs from its plain version or "
                             "the native call")
    rb, qb, qe = sam_cases.phase_a_ends(rng, g["ref_begin"],
                                        g["query_begin"], g["query_end"],
                                        c["lengths"])
    cl = g["cigar_len"].copy()
    dops = sam_cases.diff_operands(c, gbuf, cl, rb, qb, qe, dev)
    dgot = sam_cuda.sam_diff(*dops)
    dplain, diff_plain_ms = timed_once(lambda: sam_cuda.sam_diff_plain(*dops))
    same_diff = all(torch.equal(dgot[k], dplain[k]) for k in dgot)
    lp_err = float((dgot["lp"] - dplain["lp"]).abs().max())
    dg = {k: v.cpu().numpy() for k, v in dgot.items()}
    log(f"  sam_diff vs its plain version: equal {same_diff} (texts, "
        f"lengths, NM, ref_need, log10 probability: max abs err {lp_err}); "
        f"CIGAR up to {int(dg['cigar_n'].max())} B, MD up to "
        f"{int(dg['md_n'].max())} B (cap {sam_cuda.TEXT_CAP})")
    if not same_diff:
        raise AssertionError("sam_diff differs from its plain version")
    # the tie-heavy mix: tandem repeats, the tie-break decides every end
    tc = sam_cases.tandem_alignments(rng, 8192)
    tmax = sam_cuda.native_max_ops(tc["lengths"])
    tops = sam_cases.cigar_operands(tc, dev)
    tgot = sam_cuda.sam_cigar(*tops, SW_DEFAULT, 0, tmax)
    tplain = sam_cuda.sam_cigar_plain(*tops, SW_DEFAULT, 0, tmax)
    tbuf = tplain["cigar_buf"][:, :max(int(tplain["cigar_len"].max()), 1)]
    tdops = sam_cases.diff_operands(
        tc, tbuf.cpu().numpy(), tplain["cigar_len"].cpu().numpy(),
        tplain["ref_begin"].cpu().numpy().astype(np.int64),
        tplain["query_begin"].cpu().numpy(),
        tplain["query_end"].cpu().numpy(), dev)
    tdg, tdp = sam_cuda.sam_diff(*tdops), sam_cuda.sam_diff_plain(*tdops)
    same_tie = cigar_columns_equal(tgot, tplain) and \
        all(torch.equal(tdg[k], tdp[k]) for k in tdg)
    log(f"  tie-heavy mix (8192 alignments on tandem repeats, max scores "
        f"{int(tplain['score'].min())}..{int(tplain['score'].max())}): "
        f"sam_cigar and sam_diff equal to their plain versions {same_tie}")
    if not same_tie:
        raise AssertionError("the SAM kernels differ from their plain "
                             "versions on the tie-heavy mix")
    # timings, in turns
    win_len = ops[5].cpu().numpy()
    ref_start = ops[6].cpu().numpy()
    cells, nbytes = sam_cigar_work(c, win_len, ref_start, g, bands)
    plain_ms, ms, reads = turns(
        cigar_plain_ms,
        lambda: sam_cuda.sam_cigar_plain(*ops, SW_DEFAULT, 0, max_ops),
        lambda: sam_cuda.sam_cigar(*ops, SW_DEFAULT, 0, max_ops), 5)
    bound_ms, bound_by = sw_bound(cells, nbytes)
    log(f"  timing sam_cigar ({n} alignments, in turns {reads} ms): kernel "
        f"{ms:.4f} ms, {cells} cells needed ({cells / ms / 1e6:.1f} GCUPS); "
        f"bound {bound_ms:.4f} ms ({bound_by}; {OPS_PER_CELL} int32 "
        f"instructions a cell), {bound_ms / ms:.2%} of it; plain "
        f"{plain_ms:.1f} ms")
    # the split, from a profiler trace of the same call: the passes
    # kernel, the band kernel (the first launch and the relaunch), and the
    # rest of the wrapper's time (the nonzero's host sync, allocations)
    split = kernel_device_ms(
        lambda: sam_cuda.sam_cigar(*ops, SW_DEFAULT, 0, max_ops), 10)
    pass_ms = named_ms(split, "sam_pass_kernel")
    band_ms = named_ms(split, "sam_band_kernel")
    pass_cells, _ = sam_cigar_work(c, win_len, ref_start, g, [])
    pass_bound, _ = sw_bound(pass_cells, nbytes)
    band_work = band_cells_and_bytes(c, bands, runs)
    band_bound, band_by = sw_bound(*band_work)
    band_plain_ms = sum(band_plain_s) * 1e3
    log(f"  sam_cigar split (torch.profiler, 10 calls): the passes kernel "
        f"{pass_ms:.4f} ms ({pass_cells} cells, {pass_bound / pass_ms:.2%}"
        f" of their bound), the band kernel {band_ms:.4f} ms (first launch "
        f"and relaunch: {band_work[0]} cells, bound {band_bound:.4f} ms, "
        f"{band_bound / band_ms:.2%}; its plain part {band_plain_ms:.1f} ms)"
        f", the rest of the wrapper's {ms:.4f} ms "
        f"{ms - pass_ms - band_ms:.4f} ms; kernels {split}")
    cigar = {"name": "sam_cigar", "route": "cuda",
             "source": "kslam_tpu_torch/csrc/sam.cu",
             "replaces": "csrc/ssw_batch.cc:229 (kslam_ssw_cigar_batch, "
                         "host C++; no TPU kernel)",
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_ms, "bound_by": bound_by,
             "bound_share": bound_ms / ms, "cells_needed": cells,
             "passes_ms": pass_ms, "passes_bound_ms": pass_bound,
             "launch": cfg._asdict(),
             "shape": f"{n} alignments, reads of 150 bp (stride 160)",
             "turns_ms": reads, "library_ms": None}
    band = {"name": "sam_band", "route": "cuda",
            "source": "kslam_tpu_torch/csrc/sam.cu",
            "replaces": "csrc/ssw_batch.cc:104-200 (banded_cigar, host "
                        "C++; no TPU kernel), inside sam_cigar",
            "max_abs_err": err, "ms": band_ms, "plain_ms": band_plain_ms,
            "bound_ms": band_bound, "bound_by": band_by,
            "bound_share": band_bound / band_ms,
            "cells_needed": band_work[0],
            "timed_by": "torch.profiler, the band kernel's launches in 10 "
                        "sam_cigar calls; plain: banded_cigar_plain's part "
                        "of the plain sam_cigar call",
            "shape": f"{n} alignments, reads of 150 bp (stride 160)",
            "library_ms": None}
    dbytes = sam_diff_bytes(c, dg, dops[11].cpu().numpy(), cl)
    plain_ms, ms, reads = turns(diff_plain_ms,
                                lambda: sam_cuda.sam_diff_plain(*dops),
                                lambda: sam_cuda.sam_diff(*dops), 20)
    bound_ms = dbytes / MEMORY_BYTES_PER_S * 1e3
    # the kernel's own device time inside the wrapper's (the rest: the
    # wrapper's checks, allocations and fills)
    diff_dev = kernel_device_ms(lambda: sam_cuda.sam_diff(*dops), 20)
    diff_kernel_ms = named_ms(diff_dev, "sam_diff_kernel")
    log(f"  sam_diff's kernel (torch.profiler, 20 calls): {diff_kernel_ms:.4f}"
        f" ms of the wrapper's {ms:.4f} ms; every kernel of the call "
        f"{diff_dev}")
    # the serial float64 chain: one dependent add a walked M base, the
    # longest walk on each of ceil(n / in flight) rounds
    lat = dadd_latency_cycles()
    walk = int(walk_bases(dops[8].cpu().numpy(), cl).max())
    in_flight = diff_in_flight(dops[0].shape[1], dops[10].shape[1],
                               sam_cuda.TEXT_CAP)
    rounds = -(-n // in_flight)
    chain_ms = rounds * walk * lat / (sm_clock_mhz() * 1e3)
    binds = "bytes" if bound_ms >= chain_ms else "the float64 chain"
    log(f"  timing sam_diff ({n} alignments, in turns {reads} ms): kernel "
        f"{ms:.4f} ms; bound {bound_ms:.4f} ms (bytes: {dbytes} B at 3.35 "
        f"TB/s), {bound_ms / ms:.2%} of it; plain {plain_ms:.1f} ms; the "
        f"float64 chain's floor {chain_ms:.5f} ms (longest walk {walk} "
        f"adds x {lat:.2f} cycles (measured) x {rounds} rounds of at most "
        f"{in_flight} alignments in flight (a lane each, the kernel's "
        f"occupancy), at clocks.max.sm): {binds} binds")
    diff = {"name": "sam_diff", "route": "cuda",
            "source": "kslam_tpu_torch/csrc/sam.cu",
            "replaces": "kslam_tpu/io/sam.py:40 (get_cigar_and_md, host "
                        "Python; no TPU kernel)",
            "max_abs_err": lp_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes",
            "bound_share": bound_ms / ms, "bytes_needed": dbytes,
            "kernel_device_ms": diff_kernel_ms,
            "chain_floor_ms": chain_ms, "dadd_cycles": lat,
            "longest_walk": walk, "in_flight": in_flight, "binds": binds,
            "shape": f"{n} alignments, reads of 150 bp (stride 160)",
            "turns_ms": reads, "library_ms": None}
    return cigar, band, diff, phase_sam_long(rng, dev)


def phase_sam_long(rng, dev, n: int = 256, read_len: int = 1100):
    """sam_cigar on reads past the group kernel's key (1,100 bases,
    stride 1,104): the wrapper launches sam_cigar_long, equal to the plain
    version; timed in turns.  Returns its kernels line numbers."""
    from kslam_tpu_torch.eval import sam_cases
    from kslam_tpu_torch.ops import sam_cuda
    c = sam_cases.alignments(rng, sam_cases.entries(rng, 4, 100_000), n,
                             read_len=read_len, stride=read_len + 4)
    max_ops = sam_cuda.native_max_ops(c["lengths"])
    ops = sam_cases.cigar_operands(c, dev)
    if sam_cuda.takes_group(ops[0].shape[1], ops[4].shape[1], SW_DEFAULT):
        raise AssertionError("the long reads fit the group kernel")
    before = sam_launches()
    got = sam_cuda.sam_cigar(*ops, SW_DEFAULT, 0, max_ops)
    torch.cuda.synchronize()
    after = sam_launches()
    launched = {k: after[k] - before[k] for k in after}
    bands = []
    real = sam_cuda.banded_cigar_plain

    def record(*args, **kwargs):
        res = real(*args, **kwargs)
        bands.append(tuple(x.cpu().numpy() for x in
                           (args[1], args[3], args[5], res[2])))
        return res
    sam_cuda.banded_cigar_plain = record
    try:
        plain, plain_ms = timed_once(
            lambda: sam_cuda.sam_cigar_plain(*ops, SW_DEFAULT, 0, max_ops))
    finally:
        sam_cuda.banded_cigar_plain = real
    same = cigar_columns_equal(got, plain)
    err = max(int((got[k].long() - plain[k].long()).abs().max())
              for k in SAM_KEYS)
    log(f"  sam_cigar_long ({n} reads of {read_len} bases): launches "
        f"{launched}, equal to the plain version {same}")
    if not same or launched["sam_cigar_long"] < 1 or launched["sam_cigar"] \
            or launched["sam_band"]:
        raise AssertionError("the long reads did not run sam_cigar_long "
                             "or differ from the plain version")
    g = {k: got[k].cpu().numpy() for k in SAM_KEYS}
    cells, nbytes = sam_cigar_work(c, ops[5].cpu().numpy(),
                                   ops[6].cpu().numpy(), g, bands)
    plain_ms, ms, reads = turns(
        plain_ms,
        lambda: sam_cuda.sam_cigar_plain(*ops, SW_DEFAULT, 0, max_ops),
        lambda: sam_cuda.sam_cigar(*ops, SW_DEFAULT, 0, max_ops), 2)
    bound_ms, bound_by = sw_bound(cells, nbytes)
    log(f"  timing sam_cigar_long (in turns {reads} ms): kernel {ms:.4f} "
        f"ms, {cells} cells; bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.2%} of it; plain {plain_ms:.1f} ms")
    return {"name": "sam_cigar_long", "route": "cuda",
            "source": "kslam_tpu_torch/csrc/sam.cu",
            "replaces": "csrc/ssw_batch.cc:229 (kslam_ssw_cigar_batch, "
                        "host C++; no TPU kernel), for reads past the "
                        "group kernel's key",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms, "cells_needed": cells,
            "phase3_launches": launched["sam_cigar_long"],
            "shape": f"{n} alignments, reads of {read_len} bp",
            "turns_ms": reads, "library_ms": None}


def copied_reads(rng, genome, starts, rc, l: int):
    """Reads of l codes copied from genome at starts, reverse-complemented
    where rc, 1% mutated."""
    reads = genome[starts[:, None] + np.arange(l)[None, :]]
    comp = np.where(reads < 4, reads ^ 2, reads)[:, ::-1]
    reads = np.where(rc[:, None], comp, reads).astype(np.uint8)
    mut = rng.random(reads.shape) < 0.01
    reads[mut] = rng.integers(0, 4, int(mut.sum()))
    return reads


def planted_candidates(rng, genome, offsets, b: int, l: int):
    """Candidates as the device pipeline makes them: read t copied (1%
    mutated) from its entry at rel_pos, reverse-complemented on RC rows,
    so that the window at rel_pos holds it; lengths 100..l."""
    entry = rng.integers(0, len(offsets) - 1, b).astype(np.int32)
    e_len = np.diff(offsets)[entry]
    rel = (rng.random(b) * (e_len - l)).astype(np.int64)
    rc = rng.random(b) < 0.5
    reads = copied_reads(rng, genome, offsets[entry] + rel, rc, l)
    lens = rng.integers(100, l + 1, b).astype(np.int32)
    return (np.arange(b, dtype=np.int32), entry, rel.astype(np.int32), rc,
            np.ones(b, bool), reads, lens)


def realistic_candidates(rng, b: int, l: int):
    """Candidates over make_realistic_entries genomes (4 x 400 kb plus
    plasmids): a quarter at their read's own position, a quarter against
    another copy of a repeat (rRNA operon, IS element, plasmid: a 32-mer
    seen twice, at the read's offset from it), a quarter in and around
    low-complexity tracts (homopolymers, microsatellites) against
    another such tract, the rest random.  Reads are copied from the
    genomes (1% mutated); their equal-score ends stress the tie-break.
    Returns (candidate columns, genome codes, entry offsets)."""
    from kslam_tpu_torch.eval import realistic
    from kslam_tpu_torch.ops import encode
    entries = realistic.make_realistic_entries(
        n_genomes=4, bp_each=400_000, seed=int(rng.integers(1 << 30)))
    genome = encode.sw_codes_np(np.concatenate([e.seq for e in entries]))
    offsets = np.zeros(len(entries) + 1, np.int64)
    offsets[1:] = np.cumsum([len(e.seq) for e in entries])
    n = len(genome)
    # repeats: 32-mers at every 8th position seen more than once
    pos = np.arange(0, n - 32, 8)
    packed = np.zeros(len(pos), np.uint64)
    for k in range(32):
        packed = (packed << np.uint64(2)) | (genome[pos + k] & 3).astype(
            np.uint64)
    order = np.argsort(packed, kind="stable")
    same = packed[order][1:] == packed[order][:-1]
    pairs = np.stack([pos[order][1:][same], pos[order][:-1][same]], 1)
    # low-complexity: 60 bases equal to the bases 1..5 before them
    tract = np.zeros(n, bool)
    for k in range(1, 6):
        eq = np.concatenate([np.zeros(k, np.int64),
                             (genome[k:] == genome[:-k]).astype(np.int64)])
        cs = np.cumsum(eq)
        tract[60:] |= cs[60:] - cs[:-60] == 60
    tracts = np.flatnonzero(tract)
    quarter = b // 4
    src = rng.integers(0, n - l, b)                # read start in genome
    dst = src.copy()                               # window start
    if len(pairs):
        pk = pairs[rng.integers(0, len(pairs), quarter)]
        shift = rng.integers(0, l - 32, quarter)
        src[quarter:2 * quarter] = pk[:, 0] - shift
        dst[quarter:2 * quarter] = pk[:, 1] - shift
    if len(tracts):
        src[2 * quarter:3 * quarter] = tracts[rng.integers(
            0, len(tracts), quarter)] - rng.integers(0, l, quarter)
        dst[2 * quarter:3 * quarter] = tracts[rng.integers(
            0, len(tracts), quarter)] - rng.integers(0, l, quarter)
    dst[3 * quarter:] = rng.integers(0, n - l, b - 3 * quarter)
    src = np.clip(src, 0, n - l)
    dst = np.clip(dst, 0, n - 1)
    entry = (np.searchsorted(offsets, dst, side="right") - 1).astype(np.int32)
    rel = (dst - offsets[entry] + rng.integers(-3, 4, b)).astype(np.int32)
    rc = rng.random(b) < 0.5
    reads = copied_reads(rng, genome, src, rc, l)
    lens = rng.integers(100, l + 1, b).astype(np.int32)
    log(f"  realistic genomes: {len(entries)} entries, {n} bases, "
        f"{len(pairs)} repeated 32-mers, {len(tracts)} low-complexity "
        f"positions")
    return (np.arange(b, dtype=np.int32), entry, rel, rc, np.ones(b, bool),
            reads, lens), genome, offsets


def phase_align(rng, dev, b: int = 32768):
    """The fused sw_align kernel vs its plain version (the composition
    over the forward twin) at the flat window's shapes, odd shapes, the
    chunked windows of the device pipeline (uniform and realistic
    genomes) and once through align_overlaps_batch_chunked; then the
    fused kernel, the two-launch composition and the plain version timed
    at the flat and the chunked shapes.  Returns a dict of results."""
    from kslam_tpu_torch.ops import sw, sw_cuda
    l = 160
    worst = 0

    def check(name, q, r, params, n_valid=None):
        nonlocal worst
        qd, rd = torch.as_tensor(q, device=dev), torch.as_tensor(r, device=dev)
        nv = None if n_valid is None else torch.tensor(n_valid, device=dev,
                                                       dtype=torch.int32)
        before = sw_cuda.ALIGN_LAUNCHES
        got = sw_cuda.sw_align_batch(qd, rd, *params, n_valid=nv)
        launched = sw_cuda.ALIGN_LAUNCHES - before
        ref = sw_cuda.sw_align_batch_plain(qd, rd, *params, n_valid=nv)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        worst = max(worst, err)
        pos = got.score > 0
        log(f"  sw_align {name} params={params}: max_abs_err={err}, "
            f"{launched} fused launch, {int(pos.sum())}/{len(pos)} rows "
            f"score > 0, mean score {float(got.score.float().mean()):.2f}")
        if err != 0 or launched != 1:
            raise AssertionError(f"sw_align != plain on {name} {params}")
        return got

    # the flat window's shapes: planted pairs, every 7th query all N
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
        check("flat planted pairs, all-N rows", q, r, params)
    noise = rng.integers(0, 4, (b, l)).astype(np.int32)
    noise[rng.random((b, l)) < 0.05] = 4
    check("flat random 5% N", noise, r, (2, 3, 5, 2))
    qn, rn = n_windows(rng, q.copy(), r.copy())
    cfg = sw_cuda.launch_config(b, l, l, align=True)
    off_block = 37 * (cfg.threads // cfg.group) + 5
    for nv in (0, 1, b - 1, off_block):
        check(f"flat N windows, n_valid={nv}", qn, rn, (2, 3, 5, 2),
              n_valid=nv)
    ob = min(4099, b + 3)
    for olq, olr in ((1, 1), (7, 5), (20, 192), (150, 192), (161, 192)):
        for params in ((2, 3, 5, 2), (1, 4, 6, 1), (3, 2, 2, 2)):
            oq = rng.integers(0, 4, (ob, olq)).astype(np.int32)
            orr = rng.integers(0, 4, (ob, olr)).astype(np.int32)
            n = min(olq, olr)
            orr[:, :n] = np.where(rng.random((ob, n)) < 0.05, 4, oq[:, :n])
            check(f"Lq={olq} Lr={olr} B={ob}", *n_windows(rng, oq, orr),
                  params)
    oq = rng.integers(0, 4, (ob, 1024)).astype(np.int32)
    check(f"Lq=1024 Lr=1024 B={ob}",
          *n_windows(rng, oq, np.where(rng.random(oq.shape) < 0.1, 4, oq)
                     .astype(np.int32)), (1, 4, 6, 1))

    # the chunked windows of the device pipeline at its shapes
    genome = rng.integers(0, 4, 4_000_000).astype(np.uint8)
    offsets = np.array([0, 2_500_000, 4_000_000], np.int64)
    chunks = sw.genome_chunks_from_scodes(genome)

    def windows(cand, chunks_np, offsets_np):
        t = [torch.as_tensor(x, device=dev) for x in cand]
        return t, sw.chunked_windows(
            *t[:4], *t[5:], torch.as_tensor(chunks_np, device=dev),
            torch.as_tensor(offsets_np, device=dev), window_len=l)

    cand = planted_candidates(rng, genome, offsets, b, l)
    targs, win = windows(cand, chunks, offsets)
    wq, wr = win.q, win.r
    for params in ((2, 3, 5, 2), (1, 4, 6, 1), (3, 2, 2, 2)):
        check(f"chunked Lq={l} Lr={wr.shape[1]}", wq, wr, params)
    for nv in (0, 1, b - 1000, off_block):
        check(f"chunked n_valid={nv}", wq, wr, (2, 3, 5, 2), n_valid=nv)
    # once through the whole builder, against it over the plain version
    tchunks = torch.as_tensor(chunks, device=dev)
    toffsets = torch.as_tensor(offsets, device=dev)
    before = sw_cuda.ALIGN_LAUNCHES
    got = sw.align_overlaps_batch_chunked(
        *targs, tchunks, toffsets, 2, 3, 5, 2, window_len=l,
        n_valid=torch.tensor(b - 1000, device=dev))
    fused = sw_cuda.ALIGN_LAUNCHES - before
    kernel = sw_cuda.sw_align_batch
    try:
        sw_cuda.sw_align_batch = sw_cuda.sw_align_batch_plain
        ref = sw.align_overlaps_batch_chunked(
            *targs, tchunks, toffsets, 2, 3, 5, 2, window_len=l,
            n_valid=torch.tensor(b - 1000, device=dev))
    finally:
        sw_cuda.sw_align_batch = kernel
    torch.cuda.synchronize()
    err = max_abs_err(got, ref)
    worst = max(worst, err)
    log(f"  align_overlaps_batch_chunked on planted candidates: "
        f"max_abs_err={err}, {fused} fused launch (the plain run: "
        f"{sw_cuda.ALIGN_LAUNCHES - before - fused})")
    if err != 0 or fused != 1 or sw_cuda.ALIGN_LAUNCHES != before + 1:
        raise AssertionError("chunked alignment: kernel != plain")

    # realistic genomes: repeats and low-complexity tracts
    rcand, rgenome, roffsets = realistic_candidates(rng, b, l)
    rchunks = sw.genome_chunks_from_scodes(rgenome)
    _, rwin = windows(rcand, rchunks, roffsets)
    for params in ((2, 3, 5, 2), (1, 4, 6, 1), (3, 2, 2, 2)):
        got = check("chunked realistic windows", rwin.q, rwin.r, params)
    ties = int((got.score[b // 2:3 * b // 4] > 0).sum())
    log(f"  realistic: {ties} low-complexity rows with score > 0")

    # timing: the fused kernel vs the two-launch composition (old, new,
    # new, old) and the plain version, with the bound of the cells needed
    results = {"max_abs_err": worst}
    for shape, (tq, tr) in (("flat", (torch.as_tensor(q, device=dev),
                                      torch.as_tensor(r, device=dev))),
                            ("chunked", (wq, wr))):
        lq, lr = tq.shape[1], tr.shape[1]
        comp_ms, ms, turns = time_in_turns(
            lambda: sw_cuda._align_composition(
                sw_cuda.sw_forward_batch, tq, tr, 2, 3, 5, 2),
            lambda: sw_cuda.sw_align_batch(tq, tr, 2, 3, 5, 2), 20)
        plain_ms = cuda_ms(
            lambda: sw_cuda.sw_align_batch_plain(tq, tr, 2, 3, 5, 2), 3)
        al = sw_cuda.sw_align_batch(tq, tr, 2, 3, 5, 2)
        qn, rn = tq.cpu().numpy(), tr.cpu().numpy()
        aln = sw.SWAlignments(*(x.cpu().numpy() for x in al))
        cfg = sw_cuda.launch_config(b, lq, lr, align=True)
        fwd, rev = needed_cells(qn, rn, al=aln)
        cfwd, crev = computed_cells(rn, aln, cfg.group, cfg.rows)
        rect = 2 * b * lq * lr
        # the codes in once, five int32 outputs per row
        nbytes = (tq.numel() + tr.numel()) * 4 + 20 * b
        bound_ms, bound_by = sw_bound(fwd + rev, nbytes)
        log(f"  timing sw_align {shape} B={b} Lq={lq} Lr={lr}: fused "
            f"{ms:.4f} ms, two-launch composition {comp_ms:.4f} ms "
            f"(turns old/new/new/old {[round(x, 4) for x in turns]}), "
            f"plain {plain_ms:.3f} ms; cells needed {fwd + rev} (forward "
            f"{fwd}, reverse {rev}), computed by the fused kernel "
            f"{cfwd + crev} (forward {cfwd}, reverse {crev}), rectangle "
            f"{rect}: needed {(fwd + rev) / rect:.2%} and computed "
            f"{(cfwd + crev) / rect:.2%} of it; bound {bound_ms:.4f} ms "
            f"({bound_by}): fused {bound_ms / ms:.2%}, composition "
            f"{bound_ms / comp_ms:.2%} of it; {(fwd + rev) / ms / 1e6:.1f} "
            f"GCUPS needed")
        # warp divergence: the groups of a warp run their own trip counts
        # and the warp waits for its slowest.  The same rows, sorted into
        # warps of similar trip count, then those warps shuffled (so the
        # blocks' loads stay spread as in the callers' order), timed in
        # turns against the callers' order, show what that costs
        per_warp = 32 // cfg.group
        order = torch.as_tensor(
            np.argsort(trip_columns(rn, aln), kind="stable"), device=dev)
        warps = order[:b - b % per_warp].view(-1, per_warp)
        shuffle = torch.randperm(
            len(warps), generator=torch.Generator().manual_seed(0)).to(dev)
        order = torch.cat([warps[shuffle].flatten(),
                           order[b - b % per_warp:]])
        sq, sr = tq[order].contiguous(), tr[order].contiguous()
        order_ms, even_ms, even_turns = time_in_turns(
            lambda: sw_cuda.sw_align_batch(tq, tr, 2, 3, 5, 2),
            lambda: sw_cuda.sw_align_batch(sq, sr, 2, 3, 5, 2), 20)
        log(f"  warp divergence at {shape}: fused {order_ms:.4f} ms in the "
            f"callers' order, {even_ms:.4f} ms with warps of similar trip "
            f"count (turns {[round(x, 4) for x in even_turns]}): "
            f"{(order_ms - even_ms) / order_ms:.1%} of the time")
        results[shape] = {
            "B": b, "Lq": lq, "Lr": lr, "ms": ms, "composition_ms": comp_ms,
            "even_warps_ms": even_ms, "callers_order_ms": order_ms,
            "turns_old_new_new_old": turns, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms,
            "composition_bound_share": bound_ms / comp_ms,
            "cells_needed": fwd + rev, "cells_forward": fwd,
            "cells_reverse": rev, "cells_computed": cfwd + crev,
            "cells_computed_forward": cfwd, "cells_computed_reverse": crev,
            "cells_rectangle": rect}
    return results


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
                mut_rate: float = 0.01, weights=None):
    """Paired reads planted from random genomes (each as likely as the
    others, or drawn with `weights`): R1 forward at pos, R2 the reverse
    complement at pos + insert - read_len.  Returns (r1 u8 [n, L], r2
    u8 [n, L], genome index [n], R1 position [n])."""
    comp = np.zeros(256, np.uint8)
    for a, c in zip(b"ACGT", b"TGCA"):
        comp[a] = c
    bases4 = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, len(genomes), n_pairs) if weights is None else \
        rng.choice(len(genomes), n_pairs, p=weights)
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
                    sam: bool, path=None):
    """The same CLI run on cpu and on cuda: outputs byte-identical, the
    kernel launched on cuda only.  path: the name the kernels line lists
    the run under (default small_<name>).  Returns the cuda run's
    files."""
    from kslam_tpu_torch.ops import join_cuda, sw_cuda
    outs = {}
    for device in ("cpu", "cuda"):
        out = os.path.join(tmp, f"small_{name}_{device}")
        extra = list(flags) + (["--sam-file", out + ".sam"] if sam else [])
        before, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
        join_before = dict(join_cuda.JOIN_LAUNCHES)
        zero_sam_launches()
        secs = run_cli(db, out, r1, r2, device, extra)
        launched = sw_cuda.LAUNCHES - before
        fused = sw_cuda.ALIGN_LAUNCHES - fused
        joins = {k: v - join_before[k]
                 for k, v in join_cuda.JOIN_LAUNCHES.items()}
        outs[device] = read_outputs(out, sam)
        log(f"  {name} {device}: {secs:.2f} s, {launched} SW kernel "
            f"launches")
        if device == "cuda":
            check_fused(f"{name} cuda", launched, fused)
            check_join(f"{name} cuda", joins, "sector_join",
                       path=path or f"small_{name}")
            if sam:
                check_sam(f"{name} cuda", sam_launches(),
                          path=path or f"small_{name}")
        elif launched or any(joins.values()) or \
                any(sam_launches().values()):
            raise AssertionError(f"{name}: {launched} SW launches, join "
                                 f"launches {joins}, SAM launches "
                                 f"{sam_launches()} on cpu")
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
    """One CLI run on cuda with `flags` (a mesh, a chunk-pipeline depth);
    its files must equal `want` (the single-device CPU run's files),
    every SW launch fused, every join through the kernel of its table
    (window_join per mesh shard, else sector_join).  Returns its fused
    sw_align launches."""
    from kslam_tpu_torch.ops import sw_cuda
    out = os.path.join(tmp, f"small_{name}_cuda")
    extra = list(flags) + (["--sam-file", out + ".sam"] if sam else [])
    sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = 0
    zero_join_launches()
    zero_sam_launches()
    secs = run_cli(db, out, r1, r2, "cuda", extra)
    launched, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    check_join(name, join_launches(), "window_join" if "--mesh" in flags
               else "sector_join", path=f"small_{name}")
    if sam:
        check_sam(name, sam_launches(), path=f"small_{name}")
    same = read_outputs(out, sam) == want
    log(f"  {name} cuda: {secs:.2f} s, {launched} SW kernel launches; "
        f"outputs byte-identical to the single-device CPU run: {same}")
    if not same:
        raise AssertionError(f"{name}: outputs differ")
    check_fused(name, launched, fused)
    return fused


# a port CLI process that reports its SW launches, fused sw_align
# launches and join kernel launches on stdout
_CLI_PROCESS = (
    "import sys\n"
    "from kslam_tpu_torch import cli\n"
    "from kslam_tpu_torch.ops import join_cuda, sw_cuda\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print('SW launches', sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES,\n"
    "      flush=True)\n"
    "import json\n"
    "print('join launches', json.dumps(join_cuda.JOIN_LAUNCHES),\n"
    "      flush=True)\n"
    "from kslam_tpu_torch.ops import sam_cuda\n"
    "print('sam launches', json.dumps(sam_cuda.SAM_LAUNCHES), flush=True)\n"
    "sys.exit(rc)\n")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_two_processes(tmp: str, db: str, r1: str, r2, flags, want,
                      name: str = "small_two_process_cuda",
                      visible=None, join_kernel: str = "sector_join") -> int:
    """--coordinator localhost:PORT --num-processes 2 on cuda; returns
    the processes' fused sw_align launches (every SW launch fused, every
    join through join_kernel: window_join where a process's cards form a
    local mesh).  visible: each process's
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
    launches, fused, joins = [], [], []
    sams = collections.Counter()
    for pid, (p, (stdout, stderr)) in enumerate(zip(procs, results)):
        m = re.search(r"SW launches (\d+) (\d+)", stdout)
        j = re.search(r"join launches (\{.*\})", stdout)
        k = re.search(r"sam launches (\{.*\})", stdout)
        if p.returncode != 0 or m is None or j is None or k is None:
            raise AssertionError(f"process {pid} exited {p.returncode}:\n"
                                 f"{stderr[-3000:]}")
        launches.append(int(m.group(1)))
        fused.append(int(m.group(2)))
        joins.append(json.loads(j.group(1)))
        sams.update(json.loads(k.group(1)))

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
    for pid in range(2):
        check_fused(f"{name} process {pid}", launches[pid], fused[pid])
        check_join(f"{name} process {pid}", joins[pid], join_kernel)
    JOIN_PATHS[name] = {join_kernel: sum(j[join_kernel] for j in joins)}
    check_sam(name, dict(sams))
    return sum(fused)


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
    # the chunk pipeline over three chunks of 200 pairs: the cpu run
    # (depth 3) against cuda at depth 3, then cuda at depth 1, with SAM;
    # and a --mesh 2x2 classification at both depths
    chunks = ["--num-reads-at-once", "200"]
    no_overlap = ["--no-chunk-overlap"]
    chunks_sam = compare_devices(tmp, db, "chunks_sam", s1, s2, chunks,
                                 sam=True)
    launches["chunks_sam_no_overlap"] = run_mesh_cuda(
        tmp, db, "chunks_sam_no_overlap", s1, s2, chunks + no_overlap, True,
        chunks_sam)
    chunks_plain = compare_devices(tmp, db, "chunks_classify", s1, s2,
                                   chunks, sam=False)
    for name, extra in (("chunks_mesh_2x2", []),
                        ("chunks_mesh_2x2_no_overlap", no_overlap)):
        launches[name] = run_mesh_cuda(
            tmp, db, name, s1, s2, chunks + ["--mesh", "2x2"] + extra,
            False, chunks_plain)
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
        tmp, db, s1, s2, ["--num-reads-at-once", "200"], full,
        join_kernel="window_join" if torch.cuda.device_count() > 1
        else "sector_join")
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


def check_fused(name: str, launches: int, fused: int, expect=None) -> None:
    """Every SW launch of a path must be a fused sw_align launch, at
    least one, and `expect` of them where given."""
    log(f"  {name}: {fused} fused sw_align launches of {launches} SW "
        f"launches" + ("" if expect is None else f" (expected {expect})"))
    if fused == 0 or fused != launches or (expect is not None
                                           and fused != expect):
        raise AssertionError(f"{name}: {launches} SW launches, {fused} "
                             f"fused")


# each path's join kernel launches on the card, for the kernels line
JOIN_PATHS = {}
# each SAM path's sam_cigar and sam_diff launches, for the kernels line
SAM_PATHS = {}
# sam_cigar's and sam_diff's times on phase 6's alignments, per call of
# overlap_diffs, for the kernels line
RUN_TIMES = []


def sam_launches() -> dict:
    from kslam_tpu_torch.ops import sam_cuda
    return dict(sam_cuda.SAM_LAUNCHES)


def zero_sam_launches() -> None:
    from kslam_tpu_torch.ops import sam_cuda
    for k in sam_cuda.SAM_LAUNCHES:
        sam_cuda.SAM_LAUNCHES[k] = 0


def check_sam(name: str, launched: dict, path=None) -> None:
    """A SAM run on the card must launch sam_cigar's passes and band
    kernels and sam_diff (its 150 bp reads fit sam_cigar's group kernel:
    sam_cigar_long may stay at 0)."""
    log(f"  {name}: SAM kernel launches {launched}")
    if min(launched["sam_cigar"], launched["sam_band"],
           launched["sam_diff"]) == 0:
        raise AssertionError(f"{name}: a SAM kernel was not launched: "
                             f"{launched}")
    SAM_PATHS[path or name] = dict(launched)


def join_launches() -> dict:
    from kslam_tpu_torch.ops import join_cuda
    return dict(join_cuda.JOIN_LAUNCHES)


def zero_join_launches() -> None:
    from kslam_tpu_torch.ops import join_cuda
    for k in join_cuda.JOIN_LAUNCHES:
        join_cuda.JOIN_LAUNCHES[k] = 0


def check_join(name: str, launched: dict, kernel: str, path=None) -> None:
    """Every join of a path on the card went through `kernel`, the
    lookup of the path's table (sector_join with the sector table,
    window_join with the prefix window): at least one launch of it and
    none of any other join kernel.  path: the name the kernels line
    lists it under."""
    others = {k: v for k, v in launched.items() if k != kernel}
    log(f"  {name}: {launched[kernel]} {kernel} launches; others {others}")
    if launched[kernel] == 0 or any(others.values()):
        raise AssertionError(f"{name}: join launches {launched}, expected "
                             f"{kernel} only")
    if path is not None:
        JOIN_PATHS[path] = {kernel: launched[kernel]}


# DeviceDB.from_index's device peak at the end of each load, read by the
# phases' load lines (the CLI's load runs inside cli.main)
LOAD_PEAKS = []
# the last load on the card (DeviceDB.from_index or dist.place_sharded_db:
# its result and arguments) while KEPT["on"], for a phase to hold its
# columns to the host versions after the run
KEPT = {"on": False, "load": None}


def record_load_peaks() -> None:
    """Wraps DeviceDB.from_index so that each load on the card appends
    torch.cuda.max_memory_allocated() at its end to LOAD_PEAKS, and both
    it and dist.place_sharded_db so that, while KEPT["on"], the load's
    result and arguments are kept in KEPT["load"]."""
    from kslam_tpu_torch.parallel import dist
    from kslam_tpu_torch.pipeline import align
    load = align.DeviceDB.from_index.__func__
    place = dist.place_sharded_db

    def from_index(cls, *args, **kwargs):
        db = load(cls, *args, **kwargs)
        if db.kmers.device.type == "cuda":
            LOAD_PEAKS.append(torch.cuda.max_memory_allocated(
                db.kmers.device))
            if KEPT["on"]:
                KEPT["load"] = (db, args, kwargs)
        return db

    def place_sharded_db(*args, **kwargs):
        sdb = place(*args, **kwargs)
        if KEPT["on"]:
            KEPT["load"] = (sdb, args, kwargs)
        return sdb
    align.DeviceDB.from_index = classmethod(from_index)
    dist.place_sharded_db = place_sharded_db


def kept_load():
    """The load KEPT during the last run, which it stops keeping."""
    load = KEPT["load"]
    KEPT.update(on=False, load=None)
    if load is None:
        raise AssertionError("the run made no load on the card")
    return load


def equal_columns(name: str, got, want) -> dict:
    """Compares the card's columns (tensors, or ints) with the host
    versions bit for bit, one at a time; raises on any difference.
    Returns {column: True}."""
    same = {}
    for col, g in got.items():
        w = want[col]
        if isinstance(g, torch.Tensor) or isinstance(w, np.ndarray):
            same[col] = (g is None) == (w is None) and (
                g is None or (g.dtype == torch.from_numpy(w[:0]).dtype
                              and np.array_equal(g.cpu().numpy(), w)))
        else:
            same[col] = g == w
    log(f"  {name}: the columns derived on the card equal the host "
        f"versions bit for bit: {same}")
    if not all(same.values()):
        raise AssertionError(f"{name}: card-derived columns differ from "
                             f"the host versions: {same}")
    return same


def check_device_db(name: str, db, gindex, kidx) -> dict:
    """Holds a DeviceDB loaded on the card (db/device_columns.py) to the
    host versions on the same loaded index: join_columns (keys, idx_pack,
    pstart, bits, window) and genome_chunks_from_scodes(sw_codes_np(
    bases)).  Returns the host versions' seconds."""
    from kslam_tpu_torch.db.kmer_index import join_columns
    from kslam_tpu_torch.ops import encode, sw
    t0 = time.perf_counter()
    keys, pack, pstart, bits, window = join_columns(kidx)
    rows = sw.genome_chunks_from_scodes(encode.sw_codes_np(
        gindex.bases_concat))
    host_s = time.perf_counter() - t0
    equal_columns(name, dict(
        keys=db.kmers, idx_pack=db.idx_pack, pstart=db.pstart,
        bits=db.prefix_bits, window=db.prefix_window,
        genome_rows=db.genome_chunks), dict(
        keys=keys, idx_pack=pack, pstart=pstart, bits=bits, window=window,
        genome_rows=rows))
    log(f"  {name}: host versions (join_columns, sw_codes_np, "
        f"genome_chunks_from_scodes) {host_s:.4f} s on the host; "
        f"{len(kidx)} keys, {len(gindex.bases_concat)} bp")
    return dict(host_versions_s=host_s, equal=True)


def load_steps(name: str, kidx, bases, dev) -> dict:
    """Times each step of the load's derivation on the card on a loaded
    index and genome: db/device_columns.index_columns and genome_rows run
    as DeviceDB.from_index runs them, with a stage timer that
    synchronises at both ends of each part (the keys' staged copy, their
    top-bit flip, the prefix table over every width it tries with the
    sentinels, idx_pack's staged copy and packing, the bases' staged
    copy, their map to SW code rows); then the prefix table's one
    histogram at the picked width alone.  Each with the bytes it moves
    (a copy: host to card; a device step: each input read once, each
    output written once) and, for a device step, its bound at
    MEMORY_BYTES_PER_S.  Returns the numbers."""
    from kslam_tpu_torch.db import device_columns as dc
    m, g = len(kidx), len(bases)
    times = []

    @contextlib.contextmanager
    def stage(_):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)

    keys, _, _, bits, window = dc.index_columns(kidx, dev, stage)
    cap = keys.shape[0]
    rows = dc.genome_rows(bases, dev, stage=stage)
    n_rows = rows.numel()
    del keys, rows
    # (label, bytes, on the card) of index_columns' and genome_rows' parts
    parts = [("keys H2D", 8 * m, False),
             ("keys top-bit flip", 16 * m, True),
             ("prefix table (every width tried) + sentinels",
              8 * m + 8 * (cap - m), True),
             ("idx_pack H2D + pack", 9 * m, False),
             ("bases H2D", g, False),
             ("SW code map", 2 * n_rows, True)]
    if len(times) != len(parts):
        raise AssertionError(f"{len(times)} timed parts, not {len(parts)}")
    steps = {label: dict(s=t, bytes=nbytes, bound_s=nbytes /
                         MEMORY_BYTES_PER_S if on_card else None)
             for (label, nbytes, on_card), t in zip(parts, times)}
    if bits:
        d_keys = torch.as_tensor(np.asarray(kidx.kmers, np.uint64).view(
            np.int64)).to(dev) ^ dc.FLIP
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dc.prefix_counts(d_keys, bits)
        torch.cuda.synchronize(dev)
        nbytes = 8 * m + 4 * (1 << bits)
        steps[f"one histogram at {bits} bits"] = dict(
            s=time.perf_counter() - t0, bytes=nbytes,
            bound_s=nbytes / MEMORY_BYTES_PER_S)
        del d_keys
    for label, x in steps.items():
        rate = f"{x['bytes'] / x['s'] / 1e9:.2f} GB/s" if x["s"] else "-"
        bound = f", bound {x['bound_s']:.6f} s" if x["bound_s"] else ""
        log(f"  {name} load step {label}: {x['s']:.6f} s, {x['bytes']} B "
            f"({rate}{bound})")
    return dict(steps=steps, keys=m, bases=g, prefix_bits=bits,
                window=window)


def load_line(name: str, stages: dict, peak: int) -> dict:
    """Logs a run's db_load split (the three files: taxonomy, genomes,
    k-mer index; the host arrays, the staged H2D copies, the columns
    derived on the card, the sector table's build on the card; the rest),
    the peak device memory at the end of the load and over the run;
    returns the numbers."""
    sec = {k: stages.get(k, {}).get("seconds", 0.0)
           for k in ("db_load", "db_load_taxonomy", "db_load_genomes",
                     "db_load_kmers", "db_load_host", "db_load_h2d",
                     "db_load_columns", "db_load_table")}
    rest = sec["db_load"] - sum(v for k, v in sec.items() if k != "db_load")
    load_peak = LOAD_PEAKS[-1] if LOAD_PEAKS else None
    log(f"  {name} db_load {sec['db_load']:.4f} s: files (taxonomy "
        f"{sec['db_load_taxonomy']:.4f} s, genomes "
        f"{sec['db_load_genomes']:.4f} s, k-mer index "
        f"{sec['db_load_kmers']:.4f} s), host arrays "
        f"{sec['db_load_host']:.4f} s, H2D {sec['db_load_h2d']:.4f} s, "
        f"columns on the card {sec['db_load_columns']:.4f} s, sector table "
        f"on the card {sec['db_load_table']:.4f} s, the rest {rest:.4f} s; "
        f"peak device memory at the load's end {load_peak} B, over the run "
        f"{peak} B")
    return dict(sec, rest=rest, load_peak_bytes=load_peak, peak_bytes=peak)


def phase_real(rng, tmp: str, mbp: int, n_pairs: int, expect=None):
    """The real-size run; returns (its SW launches, fused launches and
    rectangle cells, and the DB, reads and planted truth for phases 6-8).
    """
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
    sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = sw_cuda.LAUNCH_CELLS = 0
    zero_join_launches()
    out = os.path.join(tmp, "real_out")
    KEPT["on"] = True
    wall = run_cli(db, out, os.path.join(tmp, "r1.fq"),
                   os.path.join(tmp, "r2.fq"), "cuda")
    launches, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    check_join("the main path", join_launches(), "sector_join",
               path="device_pipeline")
    cells = sw_cuda.LAUNCH_CELLS
    peak = torch.cuda.max_memory_allocated()
    stages = metrics.summary()
    load = load_line("classification", stages, peak)
    log(f"  against the load with host columns (PERF.md; NVIDIA H100 80GB "
        f"HBM3, 700.00 W): db_load "
        f"{load['db_load']:.4f} s (20.2676 s), its host part "
        f"{load['db_load_host']:.4f} s (host columns 10.8255 s), H2D "
        f"{load['db_load_h2d']:.4f} s (0.7576 s), peak over the run "
        f"{peak} B (9142284800 B)")
    kept, (gindex, kidx, _), _ = kept_load()
    load["columns_check"] = check_device_db("phase 5's DB", kept, gindex,
                                            kidx)
    del kept
    load["steps"] = load_steps("phase 5", kidx, gindex.bases_concat,
                               torch.device("cuda"))
    del gindex, kidx
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
    log(f"  SW kernel on the main path: {launches} launches, {cells} "
        f"rectangle cells; phase_a_sw {sw_s:.4f} s, "
        f"{cells / sw_s / 1e9 if sw_s else 0.0:.1f} G rectangle cells/s "
        f"over the stage (window building included)")
    log(f"  pairs classified to their genome's taxid: {hits}/{n_pairs} "
        f"({frac:.4%})")
    if frac < 0.99:
        raise AssertionError(f"only {frac:.4%} of planted pairs classified")
    check_fused("the main path", launches, fused, expect)
    return launches, fused, cells, dict(
        db=db, r1=os.path.join(tmp, "r1.fq"), r2=os.path.join(tmp, "r2.fq"),
        g=g, at=at, taxids=taxids, out=out, peak=peak, load=load,
        stages=stages)


def watch_sam_path():
    """For one run on the card: keeps the arguments and results of
    sam_columns.write_sam and overlap_diffs and the outputs of
    sam_cuda.sam_cigar, and counts the calls of the host versions that a
    SAM run on the card must not make (the native cigar call,
    compute_cigars_batch, get_cigar_and_md, the kernels' plain versions).
    Returns (kept, calls, restore)."""
    from kslam_tpu_torch.io import native, sam as sam_io, sam_columns
    from kslam_tpu_torch.ops import sam_cuda
    from kslam_tpu_torch.pipeline import align
    kept = {"write": [], "diffs": [], "cigar": []}
    calls = collections.Counter()
    saved = []

    def wrap(mod, name, make):
        real = getattr(mod, name)
        saved.append((mod, name, real))
        setattr(mod, name, make(real))

    def counting(label):
        def make(real):
            def call(*args, **kwargs):
                calls[label] += 1
                return real(*args, **kwargs)
            return call
        return make

    for mod, name in ((native, "ssw_cigar_batch"),
                      (align, "compute_cigars_batch"),
                      (sam_io, "get_cigar_and_md"),
                      (sam_cuda, "sam_cigar_plain"),
                      (sam_cuda, "sam_diff_plain")):
        calls[name] = 0
        wrap(mod, name, counting(name))

    def keeping(key, args_too: bool):
        def make(real):
            def call(*args, **kwargs):
                res = real(*args, **kwargs)
                kept[key].append((args, res) if args_too else res)
                return res
            return call
        return make

    wrap(sam_columns, "write_sam", keeping("write", True))
    wrap(sam_columns, "overlap_diffs", keeping("diffs", True))
    wrap(sam_cuda, "sam_cigar", keeping("cigar", False))

    def restore():
        for mod, name, real in reversed(saved):
            setattr(mod, name, real)
    return kept, calls, restore


def time_run_kernels(overlaps, filled, batch, gindex, config) -> dict:
    """sam_cigar's and sam_diff's own times (CUDA events; sam_cigar's band
    kernel by torch.profiler) on a SAM run's alignments, from the
    operands the run built (sam_columns.operands),
    the device memory their first calls take over the operands (outputs
    and scratch), and the forward and reverse passes' cells sam_cigar
    needs on them (its banded DP's cells not counted)."""
    from kslam_tpu_torch.io import sam_columns
    from kslam_tpu_torch.ops import sam_cuda
    dev = torch.device("cuda")
    t, host = sam_columns.operands(overlaps, filled, batch, gindex, config,
                                   dev)
    cargs = sam_columns.cigar_args(t, host, config)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cig = sam_cuda.sam_cigar(*cargs)
    dargs = sam_columns.diff_args(t, cig)
    sam_cuda.sam_diff(*dargs)
    torch.cuda.synchronize()
    scratch = torch.cuda.max_memory_allocated() - base
    cigar_ms = cuda_ms(lambda: sam_cuda.sam_cigar(*cargs), 3)
    band_ms = named_ms(kernel_device_ms(
        lambda: sam_cuda.sam_cigar(*cargs), 3), "sam_band_kernel")
    diff_ms = cuda_ms(lambda: sam_cuda.sam_diff(*dargs), 5)
    out = {k: cig[k].cpu().numpy() for k in SAM_KEYS}
    cells, _ = sam_cigar_work(
        {"lengths": host["lengths"], "read_id": host["read_id"],
         "rc": host["rc"]}, host["wlen"], host["ref_start"], out, [])
    return {"alignments": len(overlaps), "sam_cigar_ms": cigar_ms,
            "sam_band_ms": band_ms, "sam_diff_ms": diff_ms,
            "pass_cells": cells,
            "kernels_peak_bytes": scratch}


def check_sam_columns(kept, sam_path: str, sample: int = 20000,
                      seed: int = 0):
    """Holds a SAM run's kernel columns to the host versions: sam_cigar's
    to native.ssw_cigar_batch on every alignment; sam_diff's CIGAR, MD,
    NM and prob to the copied get_cigar_and_md on >= `sample` alignments
    (every one with an indel or a soft clip, the rest drawn); and the SAM
    lines of those alignments' reads to the copied _fill_cigars +
    write_sam_pairs.  Returns the counts checked."""
    import copy
    import io
    from kslam_tpu_torch.io import native, sam as sam_io, sam_columns
    from kslam_tpu_torch.pipeline import run as run_mod
    rng = np.random.default_rng(seed)
    counts = collections.Counter()
    picked_reads = []
    for (args, diffs), cig, (wargs, _) in zip(kept["diffs"], kept["cigar"],
                                             kept["write"]):
        overlaps, filled, batch, gindex, config, _ = args
        cols = sam_columns._columns(overlaps)
        t0 = time.perf_counter()
        nat = native.ssw_cigar_batch(
            batch.bases, batch.lengths, gindex.bases_concat,
            gindex.entry_offsets.astype(np.int64), cols["read_id"],
            cols["entry_id"], cols["rel_pos"], cols["rc"], config.sw,
            score_filter=config.score_threshold)
        nat_s = time.perf_counter() - t0
        got = {k: cig[k].cpu().numpy() for k in SAM_KEYS}
        width = int(max(nat["cigar_len"].max(), 0))
        buf = cig["cigar_buf"][:, :width].cpu().numpy()
        live = np.arange(width)[None, :] < nat["cigar_len"][:, None]
        same = all(np.array_equal(got[k], nat[k]) for k in SAM_KEYS) and \
            np.array_equal(np.where(live, buf, 0),
                           np.where(live, nat["cigar_buf"][:, :width], 0))
        log(f"  SAM run's sam_cigar columns vs native.ssw_cigar_batch on "
            f"all {len(overlaps)} alignments ({nat_s:.2f} s on the host): "
            f"equal {same}")
        if not same:
            raise AssertionError("the run's cigars differ from the native "
                                 "call's")
        counts["native"] += len(overlaps)
        timing = time_run_kernels(overlaps, filled, batch, gindex, config)
        log(f"  sam_cigar and sam_diff on this run's {len(overlaps)} "
            f"alignments (CUDA events): sam_cigar "
            f"{timing['sam_cigar_ms']:.4f} ms "
            f"({timing['pass_cells'] / timing['sam_cigar_ms'] / 1e6:.1f} "
            f"GCUPS over the forward and reverse passes' "
            f"{timing['pass_cells']} cells; its band kernel "
            f"{timing['sam_band_ms']:.4f} ms by torch.profiler), sam_diff "
            f"{timing['sam_diff_ms']:.4f} ms; the two calls' device "
            f"memory over their operands: {timing['kernels_peak_bytes']} B")
        counts["timed"] += 1
        RUN_TIMES.append(timing)
        ops = np.where(live, nat["cigar_buf"][:, :width] & 15, 0)
        indel = (ops == 1).any(1) | (ops == 2).any(1)
        m = batch.lengths[cols["read_id"]]
        clipped = (cols["query_begin"] > 0) | \
            (m - cols["query_end"] - 1 > 0)
        must = np.flatnonzero(indel | clipped)
        rest = np.setdiff1d(np.arange(len(overlaps)), must)
        extra = rng.choice(rest, min(len(rest), max(sample - len(must), 0)),
                           replace=False)
        pick = np.sort(np.concatenate([must, extra]))
        t0 = time.perf_counter()
        bad = 0
        for k in pick.tolist():
            o = copy.copy(overlaps[k])
            c = native.unpack_cigar(nat["cigar_buf"][k],
                                    nat["cigar_len"][k])
            o.cigar = (c if c is not None else []) if filled[k] else None
            d = sam_io.get_cigar_and_md(
                o, batch.base_string(o.read_id),
                batch.quality_string(o.read_id),
                gindex.entries[o.entry_id].bases)
            bad += (d.cigar, d.md, d.nm, 10.0 ** d.log_probability) != \
                (diffs[0][k], diffs[1][k], diffs[2][k], diffs[3][k])
        log(f"  SAM run's sam_diff columns vs the copied get_cigar_and_md "
            f"on {len(pick)} alignments ({int(indel[pick].sum())} with an "
            f"indel, {int(clipped[pick].sum())} soft-clipped, "
            f"{int(cols['rc'][pick].sum())} rc; "
            f"{time.perf_counter() - t0:.1f} s on the host): {bad} differ")
        if bad or len(pick) < min(sample, len(overlaps)):
            raise AssertionError(f"{bad} SAM diffs differ from the walk")
        counts["walk"] += len(pick)
        counts["indel"] += int(indel[pick].sum())
        counts["clipped"] += int(clipped[pick].sum())
        counts["rc"] += int(cols["rc"][pick].sum())
        chosen = {id(overlaps[k]) for k in pick.tolist()}
        picked_reads.append((batch, gindex, config, [
            read for read in wargs[1] if any(
                id(o) in chosen for p in read.pairs for o in (p.r1, p.r2))]))
    # the lines of those reads: the run's file against the copied writer
    lines = collections.defaultdict(list)
    with open(sam_path) as fh:
        for line in fh:
            if not line.startswith("@"):
                lines[line.split("\t", 1)[0]].append(line)
    t0 = time.perf_counter()
    differ = n_reads = 0
    for batch, gindex, config, reads in picked_reads:
        mine = copy.deepcopy(reads)
        run_mod._fill_cigars(mine, batch, gindex, config)
        for read in mine:
            text = io.StringIO()
            sam_io.write_sam_pairs(text, read, batch, gindex, config)
            differ += text.getvalue().splitlines(keepends=True) != \
                lines[batch.names[read.r1_pos]]
        n_reads += len(mine)
    log(f"  SAM lines of those {n_reads} reads vs the copied _fill_cigars "
        f"+ write_sam_pairs ({time.perf_counter() - t0:.1f} s): {differ} "
        f"reads differ")
    if differ or not n_reads:
        raise AssertionError(f"{differ} reads' SAM lines differ from the "
                             f"copied writer's")
    counts["reads"] = n_reads
    return dict(counts)


def phase_sam(ctx, tmp: str):
    """--sam-file at real size; returns the SW launch count of the run
    and the SAM kernels' launches."""
    from kslam_tpu_torch.ops import sw_cuda
    from kslam_tpu_torch.utils import metrics
    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = 0
    zero_join_launches()
    out = os.path.join(tmp, "real_sam")
    kept, host_calls, restore = watch_sam_path()
    zero_sam_launches()
    try:
        wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                       ["--sam-file", out + ".sam"])
    finally:
        restore()
    sam_k = sam_launches()
    launches, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    check_join("the SAM path", join_launches(), "sector_join", path="sam")
    check_sam("the SAM path", sam_k, path="sam")
    log(f"  host versions called on the card's SAM path: "
        f"{dict(host_calls)}")
    if any(host_calls.values()):
        raise AssertionError(f"the SAM path on the card called host "
                             f"versions: {dict(host_calls)}")
    peak = torch.cuda.max_memory_allocated()
    stages = metrics.summary()
    load_line("SAM run", stages, peak)
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
    log(f"  peak device memory {peak / 2**30:.2f} GiB ({peak} B), SW "
        f"launches {launches}")
    log(f"  R1 primary lines on the planted genome within 5 of the "
        f"planted position: {hits}/{len(g)} ({frac:.4%})")
    sam_s = stages.get("sam_output", {}).get("seconds", 0.0)
    split = {k: stages.get(k, {}).get("seconds", 0.0)
             for k in ("sam_collect", "sam_diffs", "sam_windows",
                       "sam_upload", "sam_kernels", "sam_relaunch",
                       "sam_texts", "sam_lines")}
    log(f"  sam_output {sam_s:.3f} s (before the SAM kernels, cigars by "
        f"the native host call and the Python walk: 48.783 s; NVIDIA "
        f"H100 80GB HBM3, "
        f"700.00 W): {json.dumps(split)} (sam_diffs is sam_windows + "
        f"sam_upload + sam_kernels (both kernels and the fetch) + "
        f"sam_relaunch + sam_texts); without it the run takes "
        f"{wall - sam_s:.2f} s")
    if frac < 0.99:
        raise AssertionError(f"only {frac:.4%} of SAM lines placed right")
    check_fused("the SAM path", launches, fused)
    ctx["sam_checked"] = check_sam_columns(kept, out + ".sam")
    del kept
    ctx["sam"] = out + ".sam"
    ctx["sam_output_s"] = dict(split, sam_output=sam_s)
    return launches, sam_k


def phase_host_path(ctx, tmp: str, n_pairs: int):
    """--device-pipeline off on the first n_pairs pairs; returns (SW
    launches, launches through sw_align_batch)."""
    from kslam_tpu_torch.ops import sw_cuda
    from kslam_tpu_torch.utils import metrics
    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = 0
    zero_join_launches()
    out = os.path.join(tmp, "real_host_path")
    wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                   ["--device-pipeline", "off", "--num-reads", str(n_pairs)])
    launches, through_align = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    check_join("the host-object path", join_launches(), "sector_join",
               path="host_object_path")
    peak = torch.cuda.max_memory_allocated()
    stages = metrics.summary()
    load_line("host-object path", stages, peak)
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
    check_fused("the host-object path", launches, through_align)
    return launches, through_align


def phase_mesh(ctx, tmp: str, shape: str = "2x2", expect=None):
    """--mesh SHAPE --shard-genomes at real size, its cells cycled over
    the visible cards; returns (SW launches, fused launches, rectangle
    cells) of the run."""
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
    sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = sw_cuda.LAUNCH_CELLS = 0
    zero_join_launches()
    out = os.path.join(tmp, f"real_mesh_{shape}")
    KEPT["on"] = True
    wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                   ["--mesh", shape, "--shard-genomes"])
    launches, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    check_join("the mesh path", join_launches(), "window_join",
               path=f"mesh_{shape}_shard_genomes")
    cells = sw_cuda.LAUNCH_CELLS
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
    log(f"  SW kernel on the mesh path: {launches} launches, {cells} "
        f"rectangle cells; mesh_sw {sec.get('mesh_sw', 0.0):.4f} s")
    log(f"  XML, _PerRead, _abbreviated byte-identical to phase 5: {same}")
    log(f"  shard_placement {sec.get('shard_placement', 0.0):.4f} s (the "
        f"placement with host columns, PERF.md; NVIDIA H100 80GB HBM3, "
        f"700.00 W: 13.3164 s), db_load "
        f"{sec.get('db_load', 0.0):.4f} s (8.8514 s)")
    if not same:
        raise AssertionError("the mesh run's outputs differ from phase 5")
    sdb, (_, kidx, bases, offsets), kwargs = kept_load()
    check_shards(f"mesh {shape}", sdb, kidx, bases, offsets, s_axis,
                 kwargs.get("genome_sharded", False))
    del sdb, kidx, bases
    check_fused("the mesh path", launches, fused, expect)
    return launches, fused, cells


def phase_mesh_sam(ctx, tmp: str, shape: str = "2x2"):
    """Phase 8's --mesh SHAPE --shard-genomes run again with --sam-file:
    its cards hold only their shards' genome rows, so the SAM kernels take
    windows gathered on the host.  Its SAM must equal phase 6's and its
    other outputs phase 5's."""
    from kslam_tpu_torch.utils import metrics
    metrics.reset()
    zero_join_launches()
    zero_sam_launches()
    out = os.path.join(tmp, f"real_mesh_{shape}_sam")
    wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                   ["--mesh", shape, "--shard-genomes", "--sam-file",
                    out + ".sam"])
    check_join("the mesh SAM path", join_launches(), "window_join",
               path=f"mesh_{shape}_shard_genomes_sam")
    check_sam("the mesh SAM path", sam_launches(),
              path=f"mesh_{shape}_shard_genomes_sam")
    stages = metrics.summary()
    same = read_outputs(out, sam=False) == read_outputs(ctx["out"],
                                                         sam=False)
    same_sam = read_outputs(out, sam=True)[0] == \
        read_outputs(ctx["sam"][:-len(".sam")], sam=True)[0]
    sec = {k: stages[k]["seconds"] for k in (
        "db_load", "shard_placement", "to_host_pairs", "sam_output",
        "sam_collect", "sam_diffs", "sam_windows", "sam_upload",
        "sam_kernels", "sam_relaunch", "sam_texts", "sam_lines")
        if k in stages}
    log(f"  mesh {shape} SAM run: CLI wall {wall:.2f} s; stage seconds "
        f"{json.dumps(sec)}")
    log(f"  SAM (without @PG) byte-identical to phase 6's: {same_sam}; "
        f"XML, _PerRead, _abbreviated byte-identical to phase 5: {same}")
    if not (same and same_sam):
        raise AssertionError("the mesh SAM run's outputs differ from "
                             "phases 5 and 6")


def check_shards(name: str, sdb, kidx, bases, offsets, num_shards: int,
                 genome_sharded: bool) -> None:
    """Holds each index shard and genome slice that place_sharded_db
    derived on the cards to the host versions on the same loaded index:
    shard_database(kidx, S, with_prefix=True) + index_words_np, and
    genome_chunks_from_scodes of the SW codes (shard_genomes' slices with
    --shard-genomes).  Each distinct tensor is compared once."""
    from kslam_tpu_torch.db.kmer_index import index_words_np
    from kslam_tpu_torch.ops import encode, sw
    from kslam_tpu_torch.parallel import dist
    t0 = time.perf_counter()
    km, eid, off, rc, pstart, bits, window = dist.shard_database(
        kidx, num_shards, with_prefix=True)
    per, pw = len(km) // num_shards, (1 << bits) + 1
    scodes = encode.sw_codes_np(bases)
    if genome_sharded:
        scodes, offs, _ = dist.shard_genomes(np.asarray(offsets), scodes,
                                             num_shards)
        g, e = len(scodes) // num_shards, len(offs) // num_shards
    host_s = time.perf_counter() - t0
    seen = set()
    for row in range(len(sdb.kmers)):
        for s in range(num_shards):
            if id(sdb.kmers[row][s]) in seen:
                continue
            seen.add(id(sdb.kmers[row][s]))
            sl = slice(s * per, (s + 1) * per)
            keys, pack = index_words_np(km[sl], eid[sl], off[sl], rc[sl])
            want = dict(keys=keys, idx_pack=pack, pstart=None if not bits
                        else pstart[s * pw:(s + 1) * pw], bits=bits,
                        window=window)
            got = dict(keys=sdb.kmers[row][s], idx_pack=sdb.idx_pack[row][s],
                       pstart=sdb.pstart[row][s], bits=sdb.prefix_bits,
                       window=sdb.prefix_window)
            if genome_sharded or s == 0:
                want["genome_rows"] = sw.genome_chunks_from_scodes(
                    scodes[s * g:(s + 1) * g] if genome_sharded else scodes)
                got["genome_rows"] = sdb.genome_chunks[row][s]
            if genome_sharded:
                want["entry_offsets"] = offs[s * e:(s + 1) * e]
                got["entry_offsets"] = sdb.entry_offsets[row][s]
            equal_columns(f"{name} cell ({row}, {s})", got, want)
            del keys, pack, want, got
    log(f"  {name}: host versions (shard_database, index_words_np, "
        f"sw_codes_np, shard_genomes, genome_chunks_from_scodes) "
        f"{host_s:.4f} s on the host")


def device_busy_share(trace_path: str):
    """(busy seconds, window seconds) of a torch.profiler chrome trace:
    the union of the CUDA kernel, memcpy and memset intervals inside the
    run's "chunk_loop" span (pipeline/run.py: from the first chunk's
    parse to the last chunk's tail; the DB load and the result files lie
    outside it).  A str (why not) when the trace holds no device
    interval or no span."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("name") == "chunk_loop"
             and e.get("cat") == "user_annotation"]
    device = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                    if e.get("cat") in ("kernel", "gpu_memcpy",
                                        "gpu_memset"))
    if not spans or not device:
        return (f"the trace holds {len(device)} CUDA kernel, memcpy or "
                f"memset intervals and {len(spans)} chunk_loop spans")
    lo, hi = spans[0]
    busy, end = 0.0, lo
    for a, b in device:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy / 1e6, (hi - lo) / 1e6


def phase_pipeline(ctx, tmp: str, chunk_pairs: int, expect=None):
    """Phase 5's DB and reads in chunks of chunk_pairs pairs, through the
    CLI on cuda at depth 1 (--no-chunk-overlap) and depth 3 (the
    default) in turns, three runs each: outputs byte-identical across the
    runs, >= 99% of pairs classified, every SW launch fused; then one
    profiled run at each depth for the device's busy share; then the
    copied eval/comparison.py on the runs' _PerRead.  Returns the fused
    launches of a default run."""
    from kslam_tpu_torch.db.taxonomy import TaxonomyDB
    from kslam_tpu_torch.eval import comparison
    from kslam_tpu_torch.ops import sw_cuda
    from kslam_tpu_torch.utils import metrics
    g, taxids = ctx["g"], ctx["taxids"]
    n_pairs, n_reads = len(g), 2 * len(g)
    chunk = ["--num-reads-at-once", str(chunk_pairs)]
    runs = []
    for turn, depth in enumerate((1, 3, 3, 1, 1, 3)):
        metrics.reset()
        torch.cuda.reset_peak_memory_stats()
        sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = 0
        zero_join_launches()
        out = os.path.join(tmp, f"pipeline_{turn}_d{depth}")
        wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                       chunk + (["--no-chunk-overlap"] if depth == 1
                                else []))
        launches, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
        check_join(f"chunk pipeline depth {depth} turn {turn}",
                   join_launches(), "sector_join",
                   path=f"chunk_pipeline_depth{depth}")
        peak = torch.cuda.max_memory_allocated()
        stages = metrics.summary()
        load_line(f"depth {depth} (turn {turn})", stages, peak)
        loop_s = wall - stages.get("db_load", {}).get("seconds", 0.0)
        per_read = dict(line.split("\t") for line in
                        open(out + "_PerRead").read().strip().split("\n"))
        hits = sum(per_read.get(f"r{i}") == str(taxids[k])
                   for i, k in enumerate(g.tolist()))
        sec = {k: v["seconds"] for k, v in stages.items()
               if isinstance(v, dict) and "seconds" in v}
        log(f"  depth {depth} (turn {turn}): CLI wall {wall:.4f} s "
            f"({n_reads / wall * 60:.0f} reads/min), without the DB load "
            f"{loop_s:.4f} s ({n_reads / loop_s * 60:.0f} reads/min); peak "
            f"device memory {peak / 2**30:.4f} GiB ({peak} B); pairs "
            f"classified {hits}/{n_pairs}")
        log(f"  depth {depth} (turn {turn}) stage seconds {json.dumps(sec)}")
        if hits < 0.99 * n_pairs:
            raise AssertionError(f"depth {depth}: only {hits}/{n_pairs} "
                                 f"pairs classified")
        check_fused(f"chunk pipeline depth {depth} turn {turn}", launches,
                    fused, expect)
        # a quarter of the reads per chunk cannot need more of the card
        # than phase 5's one chunk of them all, unless something (a
        # chunk, an earlier run's DB) is held too long
        if peak > ctx["peak"]:
            raise AssertionError(f"depth {depth}: peak {peak} B above "
                                 f"phase 5's one-chunk {ctx['peak']} B")
        runs.append(dict(depth=depth, out=out, wall=wall, loop_s=loop_s,
                         peak=peak, hits=hits, fused=fused))
    files = [read_outputs(r["out"], sam=False) for r in runs]
    same = all(f == files[0] for f in files[1:])
    log(f"  XML, _PerRead, _abbreviated byte-identical across the "
        f"{len(runs)} runs: {same}")
    if not same:
        raise AssertionError("the chunk pipeline's outputs differ between "
                             "depths")
    for depth in (1, 3):
        walls = [r["wall"] for r in runs if r["depth"] == depth]
        loops = [r["loop_s"] for r in runs if r["depth"] == depth]
        mean = sum(loops) / len(loops)
        log(f"  depth {depth}: walls {walls} s (mean "
            f"{sum(walls) / len(walls):.4f} s), without the load {loops} s "
            f"(mean {mean:.4f} s, {n_reads / mean * 60:.0f} reads/min), "
            f"peaks {[r['peak'] for r in runs if r['depth'] == depth]} B")

    # one profiled run at each depth: the device's busy share
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for depth in (1, 3):
        out = os.path.join(tmp, f"pipeline_profiled_d{depth}")
        trace = os.path.join(tmp, f"pipeline_d{depth}.trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], "cuda",
                           chunk + (["--no-chunk-overlap"] if depth == 1
                                    else []))
        prof.export_chrome_trace(trace)
        got = device_busy_share(trace)
        if isinstance(got, str):
            log(f"  depth {depth} busy share: not measured ({got}); "
                f"profiled wall {wall:.4f} s")
        else:
            busy, window = got
            log(f"  depth {depth} busy share: {busy / window:.4%} (device "
                f"busy {busy:.6f} s of the {window:.6f} s chunk loop, "
                f"kernels and copies of all streams, profiled wall "
                f"{wall:.4f} s; the profiler slows the host)")
        if read_outputs(out, sam=False) != files[0]:
            raise AssertionError(f"the profiled depth-{depth} run differs")

    # the copied accuracy harness on the runs' per-read output
    tax = TaxonomyDB.read_index(os.path.join(ctx["db"], "taxDB"))
    truth = {f"r{i}": taxids[k] for i, k in enumerate(g.tolist())}
    ev = comparison.evaluate_results(runs[0]["out"] + "_PerRead", truth, tax)
    n01, n10, chi = comparison.mcnemar(runs[0]["out"] + "_PerRead",
                                       runs[1]["out"] + "_PerRead", truth,
                                       tax)
    log(f"  eval.comparison: species correct {ev.species_correct} of "
        f"{ev.num_reads} reads (phase 5's count for this chunking: "
        f"{runs[0]['hits']}), {ev.num_incorrect} incorrect; McNemar depth "
        f"1 vs 3: n01={n01} n10={n10} chi2={chi}")
    if ev.species_correct != runs[0]["hits"] or (n01, n10) != (0, 0):
        raise AssertionError("eval.comparison disagrees with the run's own "
                             "count, or the depths differ per read")
    return runs[1]["fused"]


# one H100's HBM rate (the data sheet's, SXM part), bytes/s
HBM_RATE = 3.35e12
ESCAPE = 1 << 30            # a bucket row's count flag (ops/join.py)
ALL_ONES_KEY = 2**63 - 1    # the all-ones word's key (the sentinel)


def search_probes(keys, a, b, q):
    """Tier 2's binary searches (csrc/join.cu: exact_bounds) for the
    queries q with runs [a, b), vectorised: the lower bound's, then the
    upper bound's from it (the keys' end for the all-ones word).
    Returns (lo, hi, every position read)."""
    n_keys = keys.shape[0]
    b = torch.clamp(b, max=n_keys)
    probes = [a.new_zeros(0)]

    def search(a, b, upper: bool):
        a, b = a.clone(), b.clone()
        while bool((a < b).any()):
            live = a < b
            mid = a + ((b - a) >> 1)
            x = keys[torch.where(live, mid, 0)]
            probes.append(mid[live])
            go = live & ((x <= q) if upper else (x < q))
            a = torch.where(go, mid + 1, a)
            b = torch.where(live & ~go, mid, b)
        return a

    lo = search(a, b, False)
    hi = torch.where(q == ALL_ONES_KEY, n_keys, search(lo, b, True))
    return lo, hi, torch.cat(probes)


def join_bytes(q, q_ok, d_keys, d_tbl, bbits: int, d_pstart, bits: int,
               window: int):
    """The least bytes each join call moves on these queries, each input
    read once and each output written once; the lookups write lo, hi and
    uncovered (20 B a query), join_bounds lo and hi (16 B):
    * bucket_join: the 8 B keys and the distinct 64 B table rows;
      join_bounds adds q_ok of the escaped queries (1 B) and the
      distinct index keys tier 2's searches read (8 B);
    * window_join: the 8 B keys, the distinct pstart entries (4 B) and
      the distinct keys of the covered queries' runs (8 B); join_bounds
      adds q_ok of the uncovered queries and tier 2's distinct keys;
    * window_join_rows: the two-row count, the distinct keys of the
      two-row windows [pos0, pos0 + 2w) the queries cover, and 20 B of
      outputs.
    Also the count with nothing shared between queries
    (per_query_bytes: a row or a run each) and the queries sent to tier
    2; tier 2's search is modelled by search_probes, whose bounds must
    be the exact search's.  Returns {call: bytes}, {call: per-query
    bytes}, {table: kept queries to tier 2}."""
    from kslam_tpu_torch.db import sector_table
    from kslam_tpu_torch.ops import join
    n_q = q.numel()
    row = sector_table.row_of(q, bbits)
    rows = int(torch.unique(row).numel())
    start = d_tbl[:, 0][row].to(torch.int64)
    cntf = d_tbl[:, 1][row]
    escaped = cntf >= ESCAPE
    cnt = (cntf & (ESCAPE - 1)).to(torch.int64)
    t2b = q_ok & escaped & (cnt > 0)
    sel = q[t2b]
    lo_b, hi_b, probes_b = search_probes(d_keys, start[t2b],
                                         start[t2b] + cnt[t2b], sel)
    exact_b = join.searchsorted_both(d_keys, sel)
    keys_b = int(torch.unique(probes_b).numel())
    n_esc = int(escaped.sum())
    del row, start, cntf, escaped, cnt, sel

    p = join._prefix(q, bits)
    start = d_pstart[p].to(torch.int64)
    end = d_pstart[p + 1].to(torch.int64)
    pos0 = start // window * window
    covered = end <= pos0 + 2 * window
    pseen = torch.zeros(d_pstart.shape[0], dtype=torch.bool,
                        device=q.device)
    pseen[p] = True
    pseen[p + 1] = True
    entries = int(pseen.sum())
    up = torch.unique(p[covered])
    run_keys = int((d_pstart[up + 1] - d_pstart[up]).sum())
    run_reads = int(torch.where(covered, torch.clamp(end - start, min=0),
                                0).sum())
    t2w = q_ok & ~covered
    sel = q[t2w]
    lo_w, hi_w, probes_w = search_probes(d_keys, start[t2w], end[t2w], sel)
    exact_w = join.searchsorted_both(d_keys, sel)
    keys_w = int(torch.unique(probes_w).numel())
    n_unc = int((~covered).sum())
    r = pos0 // window
    seen = torch.zeros(d_keys.shape[0] // window + 1, dtype=torch.bool,
                       device=q.device)
    seen[r] = True
    seen[r + 1] = True
    window_keys = int(seen.sum()) * window
    for got, want in ((lo_b, exact_b[0]), (hi_b, exact_b[1]),
                      (lo_w, exact_w[0]), (hi_w, exact_w[1])):
        if not torch.equal(got, want):
            raise AssertionError("search_probes differs from the exact "
                                 "search")
    moved = {
        "bucket_join": n_q * 28 + rows * 64,
        "bucket_join_bounds": n_q * 24 + rows * 64 + n_esc + keys_b * 8,
        "window_join": n_q * 28 + entries * 4 + run_keys * 8,
        "window_join_bounds": n_q * 24 + entries * 4 + run_keys * 8 +
        n_unc + keys_w * 8,
        "window_join_rows": n_q * 28 + entries * 4 + window_keys * 8}
    per_query = {"bucket_join": n_q * 92,
                 "window_join": n_q * 36 + run_reads * 8,
                 "window_join_rows": n_q * (36 + 16 * window)}
    return moved, per_query, {"bucket": int(t2b.sum()),
                              "window": int(t2w.sum())}


def sector_bytes(q, q_ok, d_keys, s_tbl, sbits: int):
    """The least bytes the sector table's calls move on these queries,
    each input read once and each output written once: the 8 B keys and
    the distinct 32 B rows; the lookup writes lo, hi and uncovered (20 B
    a query), join_bounds lo and hi (16 B) and also reads q_ok of the
    escaped queries (1 B) and the distinct index keys tier 2's searches
    read (8 B; search_probes, whose bounds must be the exact search's).
    Returns ({"lookup": bytes, "join_bounds": bytes}, the lookup's bytes
    with nothing shared (a row each), kept queries to tier 2, escaped
    queries)."""
    from kslam_tpu_torch.db import sector_table as st
    from kslam_tpu_torch.ops import join
    n_q = q.numel()
    row = st.row_of(q, sbits)
    rows = int(torch.unique(row).numel())
    r = s_tbl[row]
    del row
    escaped = ((r[:, 7] >> st.ESCAPE_SHIFT) & 1) == 1
    start = r[:, 0].to(torch.int64)
    run = r[:, 2].to(torch.int64)
    del r
    t2 = q_ok & escaped & (run > 0)
    sel = q[t2]
    lo, hi, probes = search_probes(d_keys, start[t2], start[t2] + run[t2],
                                   sel)
    exact = join.searchsorted_both(d_keys, sel)
    if not (torch.equal(lo, exact[0]) and torch.equal(hi, exact[1])):
        raise AssertionError("search_probes differs from the exact search")
    keys_t2 = int(torch.unique(probes).numel())
    n_esc = int(escaped.sum())
    moved = {"lookup": n_q * 28 + rows * 32,
             "join_bounds": n_q * 24 + rows * 32 + n_esc + keys_t2 * 8}
    return moved, n_q * 60, int(t2.sum()), n_esc


def sweep_bits(m: int, extra=()):
    """The sector table sizes phase 10 tries for m keys: 2^(L - 2),
    2^(L - 1) and 2^L rows with L = ceil(log2(m)), and `extra`, within
    the table's 21..27 bits."""
    from kslam_tpu_torch.db import sector_table as st
    log2_keys = (max(m, 2) - 1).bit_length()
    return sorted({min(max(b, st.MIN_BITS), st.MAX_BITS)
                   for b in [log2_keys - 2, log2_keys - 1, log2_keys,
                             *extra]})


def build_seconds(d_keys, m: int, bits: int, turns: int = 3):
    """The sector table built on the card `turns` times (host clock, the
    card synchronised before and after each); returns (the last table,
    the seconds of each build)."""
    from kslam_tpu_torch.db import sector_table
    secs, tbl = [], None
    for _ in range(turns):
        del tbl
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tbl = sector_table.build(d_keys, m, bits)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return tbl, secs


def sector_sweep(q, q_ok, d_keys, m: int, bits_list, exact):
    """The sector table at each of bits_list, built on the card (timed);
    its lookup equal to the plain version's on every query and
    join_bounds through it (one launch) equal to the plain lookup + tier
    2 on every query and to `exact` (searchsorted_both) on every kept
    query; its bytes and tier-2 share.  Returns ({bits: table}, {bits:
    numbers}, {call name: fn} of its join_bounds, {call name: bytes})."""
    from kslam_tpu_torch.ops import join, join_cuda, match
    n_ok = int(q_ok.sum())
    tables, info, calls, moved = {}, {}, {}, {}
    for b in bits_list:
        tbl, secs = build_seconds(d_keys, m, b)
        got = join.lookup_sector(tbl, q, b)
        plain = join.lookup_sector_plain(tbl, q, b)
        err = max_abs_err(got, plain)
        del got
        before = join_cuda.JOIN_LAUNCHES["sector_join"]
        fused = match.join_bounds(q, q_ok, d_keys, idx_sector=tbl,
                                  sector_bits=b)
        launched = join_cuda.JOIN_LAUNCHES["sector_join"] - before
        same = max_abs_err(fused, match.tier2(*plain, q, q_ok, d_keys))
        kept = all(torch.equal(torch.where(q_ok, a, 0),
                               torch.where(q_ok, c, 0))
                   for a, c in zip(fused, exact))
        del fused, plain
        by, per_q, t2, n_esc = sector_bytes(q, q_ok, d_keys, tbl, b)
        name = f"sector_join_bounds@{b}"
        info[b] = dict(build_s=secs, table_bytes=int(tbl.nbytes),
                       max_abs_err=err, to_tier2=t2,
                       tier2_share=t2 / max(n_ok, 1),
                       escaped_queries=n_esc, lookup_bytes=by["lookup"],
                       join_bounds_bytes=by["join_bounds"])
        log(f"  sector table 2^{b} rows ({int(tbl.nbytes)} B): built on "
            f"the card in {[round(x, 4) for x in secs]} s; lookup equal to "
            f"the plain version on every query: {err == 0}; join_bounds "
            f"{launched} launch, equal to the plain lookup + tier 2: "
            f"{same == 0}, to searchsorted_both on kept queries: {kept}; "
            f"{t2} kept queries to tier 2 ({t2 / max(n_ok, 1):.4%})")
        if err or same or not kept or launched != 1:
            raise AssertionError(f"sector_join at {b} bits differs from its "
                                 f"plain version or the exact search")
        tables[b] = tbl
        calls[name] = (lambda t=tbl, bb=b: match.join_bounds(
            q, q_ok, d_keys, idx_sector=t, sector_bits=bb))
        moved[name] = by["join_bounds"]
    return tables, info, calls, moved


def time_flushed(calls: dict, rounds: int = 5):
    """Every call timed with CUDA events in turns (the order, then
    reversed, `rounds` times), each after a write of twice the L2 cache,
    so that every call starts from the same cold cache whatever ran
    before it.  Returns {name: (mean ms, the readings)}."""
    flush = torch.empty(25 * 2**20, dtype=torch.int32, device="cuda")
    times = {k: [] for k in calls}
    order = list(calls)
    for name in (order + order[::-1]) * rounds:
        flush.fill_(1)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = calls[name]()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end))
        del out
    return {k: (sum(v) / len(v), v) for k, v in times.items()}


def pick_bits(timed: dict, info: dict):
    """The rule of sector_table.default_bits on this run's readings: the
    smallest table whose mean join_bounds time lies within the spread
    (max - min of its turns) of the fastest table's mean.  Returns (bits,
    the fastest bits)."""
    means = {b: timed[f"sector_join_bounds@{b}"][0] for b in info}
    fastest = min(means, key=means.get)
    turns = timed[f"sector_join_bounds@{fastest}"][1]
    spread = max(turns) - min(turns)
    return min(b for b, ms in means.items()
               if ms <= means[fastest] + spread), fastest


def sweep_report(timed: dict, info: dict, moved: dict, calls: dict,
                 name: str):
    """Logs and returns each table size's join_bounds time (in phase
    10's turns, and in turns of its own after an L2 flush each, which
    the rule reads), bound, share, tier-2 share and build time, and the
    rule's pick."""
    from kslam_tpu_torch.db import sector_table
    flushed = time_flushed(calls)
    picked, fastest = pick_bits(flushed, info)
    for b, x in info.items():
        ms, turns = timed[f"sector_join_bounds@{b}"][:2]
        cold, cold_turns = flushed[f"sector_join_bounds@{b}"]
        bound = moved[f"sector_join_bounds@{b}"] / HBM_RATE * 1e3
        x.update(join_bounds_ms=ms, join_bounds_ms_turns=turns,
                 flushed_ms=cold, flushed_ms_turns=cold_turns,
                 join_bounds_bound_ms=bound, join_bounds_bound_share=bound /
                 ms)
    log(f"  {name}: fused join_bounds by table size: " + "; ".join(
        f"2^{b} rows {x['join_bounds_ms']:.4f} ms (turns "
        f"{[round(t, 4) for t in x['join_bounds_ms_turns']]}), after an "
        f"L2 flush {x['flushed_ms']:.4f} ms (turns "
        f"{[round(t, 4) for t in x['flushed_ms_turns']]}), bound "
        f"{x['join_bounds_bound_ms']:.4f} ms, "
        f"{x['join_bounds_bound_share']:.2%}, tier 2 "
        f"{x['tier2_share']:.4%}, build {min(x['build_s']):.4f} s"
        for b, x in info.items()))
    log(f"  {name}: after an L2 flush, fastest 2^{fastest} rows; the "
        f"smallest within its spread 2^{picked} rows; "
        f"sector_table.default_bits gives 2^"
        f"{sector_table.default_bits(info[picked]['index_keys'])}")
    return dict(by_bits={str(b): x for b, x in info.items()},
                fastest_bits=fastest, picked_bits=picked)


def sync_free(q, q_ok, d_keys, stbl, sbits: int) -> None:
    """join_bounds through the sector table under
    torch.cuda.set_sync_debug_mode("error"): a host synchronisation
    inside it raises."""
    from kslam_tpu_torch.ops import match
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = match.join_bounds(q, q_ok, d_keys, idx_sector=stbl,
                                sector_bits=sbits)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    del out
    log("  sector join_bounds ran under set_sync_debug_mode('error'): no "
        "host synchronisation")


def time_calls(calls: dict, rounds: int = 3):
    """Every call timed with CUDA events in turns (the order, then
    reversed, `rounds` times), and its peak device memory over the call
    above what was allocated before it.  Returns {name: (mean ms, the
    readings, peak bytes)}."""
    times = {k: [] for k in calls}
    peaks = {k: 0 for k in calls}
    order = list(calls)
    for name in (order + order[::-1]) * rounds:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = calls[name]()
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end))
        peaks[name] = max(peaks[name],
                          torch.cuda.max_memory_allocated() - base)
        del out
    return {k: (sum(v) / len(v), v, peaks[k]) for k, v in times.items()}


JOIN_KERNELS = (("sector_join", "sector"), ("bucket_join", "bucket"),
                ("window_join", "window"))


def check_join_calls(calls: dict, q_ok, n_q: int, n_ok: int):
    """Every lookup kernel equal to its plain version on every query;
    join_bounds through each table one launch, equal to
    searchsorted_both on every kept query and to the plain lookup + tier
    2 (join_bounds' plain version) on every query, and the unfused
    composition equal to it.  Returns ({kernel: {max_abs_err,
    to_tier2}}, the exact search's bounds)."""
    from kslam_tpu_torch.ops import join_cuda
    want = calls["searchsorted_both"]()
    checks = {}
    for kernel, table in JOIN_KERNELS:
        plain = calls[f"{table}_plain"]()
        got = calls[kernel]()
        torch.cuda.synchronize()
        err = max_abs_err(got, plain)
        to_tier2 = int((q_ok & (got[2] > 0)).sum())
        del got
        before = join_cuda.JOIN_LAUNCHES[kernel]
        bounds = calls[f"{kernel}_bounds"]()
        launched = join_cuda.JOIN_LAUNCHES[kernel] - before
        exact = all(torch.equal(torch.where(q_ok, a, 0),
                                torch.where(q_ok, b, 0))
                    for a, b in zip(bounds, want))
        same = [max_abs_err(bounds, calls[f"{table}_plain_bounds"]()),
                max_abs_err(bounds, calls[f"{table}_composition"]())]
        del bounds, plain
        checks[kernel] = dict(max_abs_err=err, to_tier2=to_tier2)
        log(f"  {kernel}: (lo, hi, uncovered) equal to the plain "
            f"version's on all {n_q} queries: {err == 0} (max abs err "
            f"{err}); join_bounds through it "
            f"{launched} launch, equal to searchsorted_both on the {n_ok} "
            f"kept queries: {exact}, to the plain lookup + tier 2 and to "
            f"the unfused composition on every query: max abs err {same}; "
            f"{to_tier2} kept queries to tier 2 "
            f"({to_tier2 / max(n_ok, 1):.6%})")
        if err or not exact or any(same) or launched != 1:
            raise AssertionError(f"{kernel}: the kernel differs from its "
                                 f"plain version or the exact search")
    return checks, want


def join_calls(d_keys, q, q_ok, tbl, bbits: int, pstart, bits: int,
               window: int, stbl, sbits: int):
    """The timed calls of phase 10 on (keys, queries): the exact search;
    per table (the sector table stbl at sbits, the reference's bucket
    table tbl at bbits, the prefix window pstart at bits and window) its
    lookup kernel, plain version, join_bounds (one launch), the unfused
    composition (the kernel, then match.tier2: the torch tier 2 of
    join_bounds' plain version, with torch.nonzero, searchsorted_both
    and two index_put copies) and the plain lookup + tier 2."""
    from kslam_tpu_torch.ops import join, match
    lookups = {
        "sector": (lambda: join.lookup_sector(stbl, q, sbits),
                   lambda: join.lookup_sector_plain(stbl, q, sbits),
                   dict(idx_sector=stbl, sector_bits=sbits)),
        "bucket": (lambda: join.lookup_bucket(tbl, q, bbits),
                   lambda: join.lookup_bucket_plain(tbl, q, bbits),
                   dict(idx_bucket=tbl, bucket_bits=bbits)),
        "window": (lambda: join.lookup_prefix_window(d_keys, pstart, q,
                                                     bits, window),
                   lambda: join.lookup_prefix_window_plain(
                       d_keys, pstart, q, bits, window),
                   dict(idx_pstart=pstart, prefix_bits=bits,
                        window=window))}
    calls = {"searchsorted_both": lambda: join.searchsorted_both(d_keys, q)}
    for kernel, table in JOIN_KERNELS:
        look, plain, kw = lookups[table]
        calls.update({
            kernel: look, f"{table}_plain": plain,
            f"{kernel}_bounds": lambda kw=kw: match.join_bounds(
                q, q_ok, d_keys, **kw),
            f"{table}_composition": lambda look=look: match.tier2(
                *look(), q, q_ok, d_keys),
            f"{table}_plain_bounds": lambda plain=plain: match.tier2(
                *plain(), q, q_ok, d_keys)})
    return calls


def report_join_times(timed: dict, moved: dict, per_query: dict,
                      checks: dict):
    """One line per timed call (mean ms, the readings in turns, peak over
    the call); the lookups and join_bounds with their bytes bound and
    share, join_bounds beside the unfused composition.  Returns the
    JSON-able numbers."""
    result = {}
    for name, (ms, turns, peak) in timed.items():
        result[name] = dict(ms=ms, ms_turns=turns, peak_bytes=peak)
        line = (f"  {name}: {ms:.4f} ms mean of {len(turns)} in turns "
                f"{[round(t, 4) for t in turns]}; peak over the call "
                f"{peak} B")
        if name.endswith("_join_bounds"):
            comp = timed[f"{name.split('_')[0]}_composition"][0]
            result[name]["composition_ms"] = comp
            line += (f"; the unfused composition {comp:.4f} ms, the lookup "
                     f"alone {timed[name[:-7]][0]:.4f} ms")
        if name in moved:
            bound = moved[name] / HBM_RATE * 1e3
            result[name].update(checks.get(name, {}), bytes=moved[name],
                                bound_ms=bound, bound_share=bound / ms)
            line += (f"; bytes bound {bound:.4f} ms ({moved[name]} B: what "
                     f"these queries need, each once), {bound / ms:.2%} "
                     f"of it")
            if name in per_query:
                pq = per_query[name] / HBM_RATE * 1e3
                result[name]["per_query_bound_ms"] = pq
                line += f"; with nothing shared {pq:.4f} ms"
            if f"{name}_rows" in moved:
                old = moved[f"{name}_rows"] / HBM_RATE * 1e3
                result[name].update(
                    rows_bound_ms=old, rows_bound_share=old / ms,
                    rows_per_query_bound_ms=per_query[f"{name}_rows"] /
                    HBM_RATE * 1e3)
                line += (f"; the two-row bound {old:.4f} ms, "
                         f"{old / ms:.2%} of it")
        log(line)
    return result


def join_tables_on_card(dev, kidx, keys):
    """The tables phase 10 joins through, on the card: the keys; the
    reference's bucket table, built on the host (not cached) and copied;
    the sector table at default_bits built from the keys on the card and
    compared bit for bit with the one the CPU builds from the same keys.
    Returns (keys, bucket table, its bits, sector table, its bits, the
    numbers)."""
    from kslam_tpu_torch.db import sector_table
    m = len(kidx)
    kidx.cache_dir = None
    t0 = time.perf_counter()
    tbl, bbits = kidx.bucket_table()
    host_s = time.perf_counter() - t0
    d_keys = torch.as_tensor(keys).to(dev)
    d_tbl = torch.from_numpy(np.array(tbl)).to(dev)
    del tbl
    sbits = sector_table.default_bits(m)
    stbl, secs = build_seconds(d_keys, m, sbits)
    t0 = time.perf_counter()
    cpu = sector_table.build(torch.as_tensor(keys), m, sbits)
    cpu_s = time.perf_counter() - t0
    same = torch.equal(cpu, stbl.cpu())
    del cpu
    log(f"  reference bucket table 2^{bbits} rows built on the host in "
        f"{host_s:.4f} s (not on any CLI path); sector table 2^{sbits} rows "
        f"({int(stbl.nbytes)} B) built on the card in "
        f"{[round(x, 4) for x in secs]} s, on the CPU in {cpu_s:.4f} s; "
        f"equal bit for bit: {same}")
    if not same:
        raise AssertionError("the sector table built on the card differs "
                             "from the CPU's")
    return d_keys, d_tbl, bbits, stbl, sbits, dict(
        bucket_host_build_s=host_s, sector_card_build_s=secs,
        sector_cpu_build_s=cpu_s, sector_bits=sbits,
        sector_table_bytes=int(stbl.nbytes))


def join_all(d_keys, q, q_ok, d_tbl, bbits, d_pstart, bits, window, stbl,
             sbits, m, n_q, n_ok, name: str, extra_bits=()):
    """Phase 10's checks and timings on one index: every table's calls
    (join_calls) checked and timed in turns beside the sector table's
    join_bounds at each size of sweep_bits; the bytes bounds; the rule's
    pick.  Returns the JSON-able numbers."""
    calls = join_calls(d_keys, q, q_ok, d_tbl, bbits, d_pstart, bits,
                       window, stbl, sbits)
    checks, exact = check_join_calls(calls, q_ok, n_q, n_ok)
    sync_free(q, q_ok, d_keys, stbl, sbits)
    tables, info, sweep_calls, sweep_moved = sector_sweep(
        q, q_ok, d_keys, m, sweep_bits(m, extra_bits), exact)
    del exact
    for x in info.values():
        x["index_keys"] = m
    moved, per_query, tier2 = join_bytes(q, q_ok, d_keys, d_tbl, bbits,
                                         d_pstart, bits, window)
    by, per_q, t2, _ = sector_bytes(q, q_ok, d_keys, stbl, sbits)
    moved.update(sector_join=by["lookup"], sector_join_bounds=by[
        "join_bounds"], **sweep_moved)
    per_query["sector_join"] = per_q
    tier2["sector"] = t2
    for kernel, table in JOIN_KERNELS:
        if tier2[table] != checks[kernel]["to_tier2"]:
            raise AssertionError(f"{kernel}: {tier2[table]} tier-2 queries "
                                 f"in the bound, "
                                 f"{checks[kernel]['to_tier2']} in the run")
    calls.update(sweep_calls)
    timed = time_calls(calls)
    result = report_join_times(timed, moved, per_query, checks)
    result["sector_sizes"] = sweep_report(timed, info, moved, sweep_calls,
                                          name)
    del tables, calls, sweep_calls
    result.update(
        queries=n_q, kept=n_ok, index_keys=m, bucket_bits=bbits,
        sector_bits=sbits, prefix_bits=bits, window=window,
        tier2_share={kernel: c["to_tier2"] / max(n_ok, 1)
                     for kernel, c in checks.items()},
        table_bytes={"sector": int(stbl.nbytes), "bucket": int(d_tbl.nbytes),
                     "prefix_window": int(d_pstart.nbytes)})
    return result


def phase_join(ctx, tmp: str, dev, seed: int):
    """The join's kernels on phase 5's DB and the k-mers of all its reads
    at once: sector_join (lookup_sector on the card; the main path's),
    bucket_join (lookup_bucket on the reference's table) and window_join
    (lookup_prefix_window) against their plain versions on every query
    (lo, hi, uncovered); match.join_bounds through each (one launch,
    tier 2 inside) against the exact search (searchsorted_both, the
    library call) on every kept query (q_ok) and against the plain
    lookup + tier 2 and the unfused composition on every query; the
    sector table built on the card, equal bit for bit to the CPU's, and
    at 2^25, 2^26 and 2^27 rows; every call timed with CUDA events in
    turns: ms, peak device memory over the call, the bytes bound and
    share (and the two-row bound), and tier 2's share of kept queries.
    Then the repeat-rich case (join_repeats) and one --no-prefix-rows
    CLI run on the card (window_join on the path), byte-identical to
    phase 5's.  Returns the JSON-able numbers."""
    from kslam_tpu_torch.db.kmer_index import KmerIndex, join_columns
    from kslam_tpu_torch.io.fastq import stream_read_batches
    from kslam_tpu_torch.ops import encode, kmers, sw_cuda
    from kslam_tpu_torch.utils import metrics
    kidx = KmerIndex.load(ctx["db"])
    keys, _, pstart, bits, window = join_columns(kidx)
    m = len(kidx)
    d_keys, d_tbl, bbits, stbl, sbits, built = join_tables_on_card(
        dev, kidx, keys)
    d_pstart = torch.as_tensor(pstart).to(dev)
    del kidx, keys
    n_pairs = len(ctx["g"])
    batch = next(stream_read_batches(ctx["r1"], ctx["r2"], n_pairs,
                                     pad_len=160))
    l = min(160, -(-int(batch.lengths.max()) // 8) * 8)
    bases = torch.as_tensor(np.ascontiguousarray(batch.bases[:, :l])).to(dev)
    lengths = torch.as_tensor(batch.lengths).to(dev)
    km, _, _, valid = kmers.read_kmers_from_codes(encode.kmer_codes(bases),
                                                  lengths)
    q = km.reshape(-1)
    q_ok = valid.reshape(-1) & (q != kmers.FLIP)
    n_q, n_ok = q.shape[0], int(q_ok.sum())
    del bases, km, valid
    log(f"  index {m} keys (padded {d_keys.shape[0]}), prefix table "
        f"{bits} bits, window {window}; bucket table {bbits} bits; sector "
        f"table {sbits} bits; {batch.num_reads} reads at once: {n_q} query "
        f"positions, {n_ok} kept (valid, not the zero k-mer)")
    result = join_all(d_keys, q, q_ok, d_tbl, bbits, d_pstart, bits,
                      window, stbl, sbits, m, n_q, n_ok, "uniform")
    result["table_build"] = built
    # the tables and queries go before the next index and the CLI run,
    # whose peaks are their own
    del d_tbl, d_pstart, d_keys, stbl, q, q_ok, lengths
    result["repeat_rich"] = join_repeats(dev, seed)

    # --no-prefix-rows on the card: the prefix window and tier 2 on the
    # CLI path, no sector table
    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = 0
    zero_join_launches()
    out = os.path.join(tmp, "real_no_prefix_rows")
    wall = run_cli(ctx["db"], out, ctx["r1"], ctx["r2"], dev.type,
                   ["--no-prefix-rows"])
    launches, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    check_join("the --no-prefix-rows path", join_launches(), "window_join",
               path="no_prefix_rows")
    peak = torch.cuda.max_memory_allocated()
    stages = metrics.summary()
    same = read_outputs(out, sam=False) == read_outputs(ctx["out"],
                                                         sam=False)
    seed = stages.get("phase_a_seed", {}).get("seconds", 0.0)
    log(f"  --no-prefix-rows CLI run: wall {wall:.4f} s, phase_a_seed "
        f"{seed:.4f} s (phase 5, sector join: "
        f"{ctx['stages'].get('phase_a_seed', {}).get('seconds', 0.0):.4f}"
        f" s), peak device memory {peak} B (phase 5: {ctx['peak']} B); "
        f"XML, _PerRead, _abbreviated byte-identical to phase 5: {same}")
    load_line("--no-prefix-rows run", stages, peak)
    log(f"  stages: {json.dumps(stages)}")
    if not same:
        raise AssertionError("the --no-prefix-rows run differs from "
                             "phase 5")
    check_fused("the --no-prefix-rows path", launches, fused)
    result["no_prefix_rows_cli"] = dict(wall_s=wall, phase_a_seed_s=seed,
                                        peak_bytes=peak)
    result["phase5_load"] = ctx["load"]
    return result


def join_repeats(dev, seed: int, n_genomes: int = 96,
                 bp_each: int = 1_700_000, n_reads: int = 262_144):
    """The join on a repeat-rich index: eval/realistic genomes (n_genomes
    x bp_each bp, with shared rRNA operons, IS-element families,
    low-complexity tracts and a shared plasmid), indexed by the port's
    KmerIndex.build at the reference's stride (>= 1e7 keys), the
    reference's bucket table and the prefix window built on the host and
    put on the card with the keys, the sector table built on the card
    (equal to the CPU's); the queries are the k-mers of n_reads 150 bp
    reads copied from those genomes on the card.  At least 1% of the
    kept queries must go to tier 2 with the bucket table.  The same
    checks and timings as phase 10's uniform index (join_all), the
    sector table also at 2^25-2^27 rows.  Returns the JSON-able
    numbers."""
    from kslam_tpu_torch.db import device_columns
    from kslam_tpu_torch.db.genbank import GenbankEntry, GenbankIndex
    from kslam_tpu_torch.db.kmer_index import KmerIndex, join_columns
    from kslam_tpu_torch.eval import realistic
    from kslam_tpu_torch.ops import encode, kmers, sw
    t0 = time.perf_counter()
    entries = realistic.make_realistic_entries(
        n_genomes=n_genomes, bp_each=bp_each, seed=seed + 7)
    seqs = [e.seq for e in entries]
    kidx = KmerIndex.build(GenbankIndex([
        GenbankEntry(bases=s.tobytes().decode()) for s in seqs]))
    keys, pack, pstart, bits, window = join_columns(kidx)
    m = len(kidx)
    build_s = time.perf_counter() - t0
    # the columns and genome rows db/device_columns derives on the card
    # from this index and these genomes, against the host versions
    t0 = time.perf_counter()
    got = device_columns.index_columns(kidx, dev)
    rows = device_columns.genome_rows(np.concatenate(seqs), dev)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    equal_columns("the repeat-rich index", dict(
        zip(("keys", "idx_pack", "pstart", "bits", "window"), got),
        genome_rows=rows), dict(
        keys=keys, idx_pack=pack, pstart=pstart, bits=bits, window=window,
        genome_rows=sw.genome_chunks_from_scodes(encode.sw_codes_np(
            np.concatenate(seqs)))))
    log(f"  repeat-rich index: columns and genome rows derived on the card "
        f"in {card_s:.4f} s")
    del got, rows, pack
    if m < 10**7:
        raise AssertionError(f"the repeat-rich index holds {m} keys, "
                             f"under 1e7")
    d_keys, d_tbl, bbits, stbl, sbits, built = join_tables_on_card(
        dev, kidx, keys)
    d_pstart = torch.as_tensor(pstart).to(dev)
    del kidx, keys
    rng = np.random.default_rng(seed + 8)
    lens = np.array([len(s) for s in seqs])
    first = np.concatenate([[0], np.cumsum(lens)[:-1]])
    ent = rng.choice(len(seqs), n_reads, p=lens / lens.sum())
    starts = first[ent] + rng.integers(0, lens[ent] - 150)
    genome = torch.as_tensor(np.concatenate(seqs)).to(dev)
    idx = torch.as_tensor(starts).to(dev)[:, None] + \
        torch.arange(150, device=dev)[None, :]
    lengths = torch.full((n_reads,), 150, dtype=torch.int64, device=dev)
    km, _, _, valid = kmers.read_kmers_from_codes(
        encode.kmer_codes(genome[idx]), lengths)
    del genome, idx, seqs, entries
    q = km.reshape(-1)
    q_ok = valid.reshape(-1) & (q != kmers.FLIP)
    n_q, n_ok = q.shape[0], int(q_ok.sum())
    del km, valid, lengths
    log(f"  repeat-rich index: {n_genomes} realistic genomes x {bp_each} "
        f"bp + plasmids, {m} keys (padded {d_keys.shape[0]}), prefix "
        f"table {bits} bits, window {window}; bucket table {bbits} bits; "
        f"sector table {sbits} bits; built in {build_s:.1f} s; {n_reads} "
        f"reads copied from the genomes: {n_q} query positions, {n_ok} "
        f"kept")
    result = join_all(d_keys, q, q_ok, d_tbl, bbits, d_pstart, bits,
                      window, stbl, sbits, m, n_q, n_ok, "repeat-rich",
                      extra_bits=(25, 26, 27))
    share = result["tier2_share"]["bucket_join"]
    if share < 0.01:
        raise AssertionError(f"repeat-rich: {share:.4%} of kept queries to "
                             f"tier 2 with the bucket table, under 1%")
    result.update(build_s=build_s, table_build=built, n_genomes=n_genomes,
                  bp_each=bp_each, reads=n_reads, columns_on_card_s=card_s)
    return result


def join_kernel_entries(joins: dict):
    """The kernels line's entries of the join kernels from phase 10's
    `joins`: launches on each one's own path (sector_join on the main
    path, bucket_join on none, window_join with --no-prefix-rows; a
    join_bounds call is one launch) and on every path (JOIN_PATHS); the
    lookup's time, plain version's, bytes bound (window_join also the
    two-row bound); join_bounds' time (tier 2 in the launch) beside the
    unfused composition, the plain lookup + tier 2 and their peaks; the
    repeat-rich case's; the sector table's sizes; and the exact search's
    time (library_ms)."""
    entries = []
    rich = joins["repeat_rich"]
    for kernel, main_path, line in (
            ("sector_join", "device_pipeline", 146),
            ("bucket_join", "device_pipeline", 146),
            ("window_join", "no_prefix_rows", 244)):
        table = kernel.split("_")[0]
        j, b = joins[kernel], joins[f"{kernel}_bounds"]
        entry = {
            "name": kernel, "route": "cuda",
            "source": "kslam_tpu_torch/csrc/join.cu",
            "replaces": f"kslam_tpu/ops/join.py:{line}",
            "launches": JOIN_PATHS[main_path].get(kernel, 0),
            "launches_by_path": {p: c[kernel] for p, c in JOIN_PATHS.items()
                                 if kernel in c},
            "max_abs_err": j["max_abs_err"], "ms": j["ms"],
            "plain_ms": joins[f"{table}_plain"]["ms"],
            "bound_ms": j["bound_ms"], "bound_by": "bytes",
            "bound_share": j["bound_share"],
            "per_query_bound_ms": j["per_query_bound_ms"],
            "join_bounds_ms": b["ms"], "join_bounds_bound_ms": b["bound_ms"],
            "join_bounds_bound_share": b["bound_share"],
            "composition_ms": b["composition_ms"],
            "join_bounds_plain_ms": joins[f"{table}_plain_bounds"]["ms"],
            "join_bounds_peak_bytes": b["peak_bytes"],
            "composition_peak_bytes":
                joins[f"{table}_composition"]["peak_bytes"],
            "to_tier2": j["to_tier2"],
            "repeat_rich": {
                "ms": rich[kernel]["ms"],
                "join_bounds_ms": rich[f"{kernel}_bounds"]["ms"],
                "composition_ms": rich[f"{kernel}_bounds"]["composition_ms"],
                "join_bounds_bound_ms": rich[f"{kernel}_bounds"]["bound_ms"],
                "tier2_share": rich["tier2_share"][kernel]},
            "queries": joins["queries"],
            "library_ms": joins["searchsorted_both"]["ms"]}
        if kernel == "window_join":
            entry.update(rows_bound_ms=j["rows_bound_ms"],
                         rows_bound_share=j["rows_bound_share"])
        if kernel == "sector_join":
            entry.update(table_bits=joins["sector_bits"],
                         table_build=joins["table_build"],
                         sizes=joins["sector_sizes"],
                         repeat_rich_sizes=rich["sector_sizes"])
        entries.append(entry)
    return entries


# --- phase 11: DB provisioning ---

INSTALL_ASSEMBLIES = 64        # + 3 rows the installer must skip
INSTALL_BIG_BP = 10_000_000    # one chromosome above the 1-8 Mbp spread
INSTALL_GENERA = 8
INSTALL_PAIRS = 32768
# the cpu run's pairs: its plain SW takes ~40 ms a pair on these genomes
# on the card's host, so 4,096 pairs would add ~3 minutes
INSTALL_CPU_PAIRS = 512
PARSE_MBP = (1, 2, 4)


def timed(fn, timers: dict, name: str):
    """fn, adding its seconds to timers[name] at every call."""
    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            timers[name] = timers.get(name, 0.0) + time.perf_counter() - t0
    return run


def write_install_mirror(rng, root: str, seed: int):
    """The local NCBI mirror of phase 11 (eval/ncbi_mirror, written by a
    pool of spawned processes): INSTALL_ASSEMBLIES complete, latest
    bacteria (chromosomes at the quantiles of a 4 Mbp-median log-normal
    within 1-8 Mbp, one of 10 Mbp; the shared plasmid on every third;
    ~0.86 genes a kbp; species in INSTALL_GENERA genera under Bacteria),
    and among them a replaced assembly, a scaffold-level one and one
    without an ftp_path.  Returns (assemblies in the summary's order,
    each one's write_gbff dicts, taxa)."""
    import multiprocessing
    from kslam_tpu_torch.eval import ncbi_mirror as nm
    n = INSTALL_ASSEMBLIES
    lengths = nm.spread_lengths(n - 1) + [INSTALL_BIG_BP]
    order = rng.permutation(n)
    asms = [nm.Assembly(g, lengths[k], plasmid=g % 3 == 0)
            for g, k in enumerate(order.tolist())]
    for at, asm in ((5, nm.Assembly(n, 200_000, version_status="replaced")),
                    (20, nm.Assembly(n + 1, 200_000,
                                     assembly_level="Scaffold")),
                    (40, nm.Assembly(n + 2, 200_000, listed_path=False))):
        asms.insert(at, asm)
    taxa = nm.genus_taxa(n + 3, INSTALL_GENERA)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(
            min(8, os.cpu_count() or 1), mp_context=ctx) as pool:
        written = nm.write_mirror(root, asms, taxa, seed=seed,
                                  map_fn=pool.map)
    return asms, written, taxa


def install_twice(mirror: str, db: str, work: str, want):
    """install_db.main(--db DB --work W --bacteria) with fetch bound to
    the mirror, twice: the first must fetch the taxdump, the summary and
    exactly the GBFFs `want` (in order), the second nothing, and both
    must write the same DB files.  Returns each run's stage seconds and
    the DB's snapshot."""
    from kslam_tpu_torch import cli, install_db
    from kslam_tpu_torch.db import gbff
    from kslam_tpu_torch.eval import ncbi_mirror as nm
    fetched = []
    local = nm.local_fetch(mirror)

    def fetch(url, dest):
        fetched.append(url)
        local(url, dest)
    saved = (install_db.fetch, install_db.download_taxonomy,
             install_db.download_genomes, cli.main, gbff.index_from_gbff)
    runs, snapshots = [], []
    try:
        for run in range(2):
            timers = {}
            fetched.clear()
            install_db.fetch = fetch
            install_db.download_taxonomy = timed(
                saved[1], timers, "taxonomy fetch + extract")
            install_db.download_genomes = timed(
                saved[2], timers, "genome fetch + gunzip")
            cli.main = lambda argv: timed(saved[3], timers, argv[0])(argv)
            gbff.index_from_gbff = timed(saved[4], timers, "GBFF parse")
            t0 = time.perf_counter()
            if install_db.main(["--db", db, "--work", work,
                                "--bacteria"]) != 0:
                raise AssertionError("install_db.main failed")
            total = time.perf_counter() - t0
            gbffs = [u for u in fetched if u.endswith(".gbff.gz")]
            sec = {k: timers.get(k, 0.0) for k in (
                "taxonomy fetch + extract", "genome fetch + gunzip",
                "--parse-taxonomy", "GBFF parse")}
            sec["index build + save"] = timers.get("--parse-genbank", 0.0) \
                - sec["GBFF parse"]
            sec["total"] = total
            log(f"  install {run + 1}: {len(fetched)} fetches "
                f"({len(gbffs)} GBFFs); seconds "
                + ", ".join(f"{k} {v:.4f}" for k, v in sec.items()))
            if run == 0 and (gbffs != want or len(fetched) != len(want) + 2):
                raise AssertionError(f"the install fetched {len(gbffs)} "
                                     f"GBFFs, not the {len(want)} complete, "
                                     f"latest assemblies")
            if run == 1 and fetched:
                raise AssertionError(f"the second install fetched "
                                     f"{len(fetched)} files")
            runs.append(sec)
            snapshots.append(nm.db_files(db))
    finally:
        (install_db.fetch, install_db.download_taxonomy,
         install_db.download_genomes, cli.main,
         gbff.index_from_gbff) = saved
    same = snapshots[0] == snapshots[1]
    log(f"  second install: 0 fetches, DB files identical to the first's "
        f"(each file byte for byte, an .npz member by member): {same} "
        f"({sorted(snapshots[0])})")
    if not same:
        raise AssertionError("the second install wrote other DB files")
    return runs, snapshots[0]


def compare_parsers(tmp: str, taxa, seed: int):
    """db/genbank.index_from_gbff (the reference's parser, quadratic)
    against db/gbff.index_from_gbff on one-genome GBFFs of PARSE_MBP
    Mbp, in turns (linear, copy, linear); equal entries required.
    Returns the seconds by size."""
    from kslam_tpu_torch.db import gbff, genbank
    from kslam_tpu_torch.eval import ncbi_mirror as nm
    out = {}
    for i, mbp in enumerate(PARSE_MBP):
        path = os.path.join(tmp, f"parse_{mbp}mbp.gbff")
        nm.write_gbff(path, nm.spread_assembly(i, mbp * 1_000_000, taxa,
                                               seed))
        secs, results = [], []
        for parse in (gbff.index_from_gbff, genbank.index_from_gbff,
                      gbff.index_from_gbff):
            t0 = time.perf_counter()
            results.append(parse([path]).entries)
            secs.append(time.perf_counter() - t0)
        same = results[0] == results[1] == results[2]
        genes = sum(len(e.genes) for e in results[0])
        lin = min(secs[0], secs[2])
        log(f"  parse {mbp} Mbp ({genes} genes): copy {secs[1]:.4f} s, "
            f"linear {secs[0]:.4f} / {secs[2]:.4f} s, copy/linear "
            f"{secs[1] / lin:.1f}x; equal entries: {same}")
        if not same:
            raise AssertionError(f"the parsers differ at {mbp} Mbp")
        out[mbp] = {"copy_s": secs[1], "linear_s": [secs[0], secs[2]]}
        os.remove(path)
    return out


def phase_install(rng, tmp: str, seed: int):
    """Phase 11: write the mirror, install from it twice, compare the
    parsers, then classify INSTALL_PAIRS planted pairs on the installed
    DB on the card, and the first INSTALL_CPU_PAIRS on cpu and cuda.
    Returns the JSON-able numbers."""
    from kslam_tpu_torch.ops import sw_cuda
    from kslam_tpu_torch.utils import metrics
    t0 = time.perf_counter()
    mirror = os.path.join(tmp, "ncbi_mirror")
    asms, written, taxa = write_install_mirror(rng, mirror, seed)
    mirror_s = time.perf_counter() - t0
    installed = [(a, d) for a, d in zip(asms, written) if a.installed]
    genomes = [np.frombuffer(d[0]["seq"].encode(), np.uint8)
               for _, d in installed]
    bp = sum(len(e["seq"]) for _, d in installed for e in d)
    entries = sum(len(d) for _, d in installed)
    genes = sum(len(e["genes"]) for _, d in installed for e in d)
    lengths = np.array([len(x) for x in genomes])
    plasmids = sum(a.plasmid for a, _ in installed)
    log(f"  mirror: {len(asms)} assemblies ({len(installed)} complete and "
        f"latest), {bp} bp in {entries} entries ({plasmids} plasmids), "
        f"{genes} genes ({genes / bp * 1000:.3f} a kbp); chromosomes "
        f"{lengths.min()}-{lengths.max()} bp, median "
        f"{int(np.median(lengths))}; written in {mirror_s:.1f} s")
    db = os.path.join(tmp, "installed_db")
    runs, files = install_twice(mirror, db, os.path.join(tmp, "install_work"),
                                [a.gbff_url for a, _ in installed])
    with np.load(os.path.join(db, "kmer_index.npz")) as z:
        n_keys = int(z["kmers"].shape[0])
    meta_genes = files["meta.json"].count(b'"cds_start"')
    log(f"  installed DB: {bp} bp, {entries} entries, {meta_genes} genes "
        f"after the parser's dedup, {n_keys} index keys")
    del files
    parse = compare_parsers(tmp, taxa, seed)

    # classification on the installed DB, reads drawn by chromosome length
    r1, r2, g, _ = plant_pairs(rng, genomes, INSTALL_PAIRS,
                               weights=lengths / lengths.sum())
    names = [f"i{i}".encode() for i in range(INSTALL_PAIRS)]
    paths = [os.path.join(tmp, f"install_{x}.fq") for x in
             ("r1", "r2", "c1", "c2")]
    write_fastq(paths[0], names, r1)
    write_fastq(paths[1], names, r2)
    write_fastq(paths[2], names[:INSTALL_CPU_PAIRS], r1[:INSTALL_CPU_PAIRS])
    write_fastq(paths[3], names[:INSTALL_CPU_PAIRS], r2[:INSTALL_CPU_PAIRS])
    del r1, r2
    metrics.reset()
    torch.cuda.reset_peak_memory_stats()
    sw_cuda.LAUNCHES = sw_cuda.ALIGN_LAUNCHES = 0
    zero_join_launches()
    out = os.path.join(tmp, "installed_out")
    KEPT["on"] = True
    wall = run_cli(db, out, paths[0], paths[1], "cuda")
    launches, fused = sw_cuda.LAUNCHES, sw_cuda.ALIGN_LAUNCHES
    joins = join_launches()
    check_join("the installed DB", joins, "sector_join")
    JOIN_PATHS["installed_db"] = joins
    peak = torch.cuda.max_memory_allocated()
    stages = metrics.summary()
    load = load_line("installed DB", stages, peak)
    kept, (gindex, kidx, _), _ = kept_load()
    load["columns_check"] = check_device_db("the installed DB", kept,
                                            gindex, kidx)
    del kept
    load["steps"] = load_steps("installed DB", kidx, gindex.bases_concat,
                               torch.device("cuda"))
    del gindex, kidx
    species = [100 + installed[k][0].g for k in g.tolist()]
    per_read = dict(line.split("\t") for line in
                    open(out + "_PerRead").read().strip().split("\n"))
    got = [per_read.get(f"i{i}") for i in range(INSTALL_PAIRS)]
    at_species = sum(x == str(t) for x, t in zip(got, species))
    at_genus = sum(x == str(taxa[t][0]) for x, t in zip(got, species))
    with open(out) as fh:
        xml = fh.read()
    gene_rows = re.findall(r'<gene [^>]*numReads="(\d+)"', xml)
    n_reads = 2 * INSTALL_PAIRS
    loop_s = wall - stages.get("db_load", {}).get("seconds", 0.0)
    frac = (at_species + at_genus) / INSTALL_PAIRS
    log(f"  classification: {n_reads} reads, CLI wall {wall:.2f} s "
        f"({n_reads / wall * 60:.0f} reads/min), without the DB load "
        f"{loop_s:.2f} s ({n_reads / loop_s * 60:.0f} reads/min); peak "
        f"device memory {peak} B")
    log(f"  stages: {json.dumps(stages)}")
    log(f"  pairs to their genome's taxid {at_species}/{INSTALL_PAIRS} "
        f"({at_species / INSTALL_PAIRS:.4%}), to its genus {at_genus}; "
        f"either {frac:.4%}; gene hits in the XML: {len(gene_rows)} genes, "
        f"{sum(int(x) for x in gene_rows)} reads")
    if frac < 0.99 or not gene_rows:
        raise AssertionError(f"installed DB: {frac:.4%} of pairs to their "
                             f"taxid or genus, {len(gene_rows)} gene hits")
    check_fused("the installed DB", launches, fused)

    # the card against the cpu on the first pairs
    t0 = time.perf_counter()
    compare_devices(tmp, db, f"installed_db_{INSTALL_CPU_PAIRS}", paths[2],
                    paths[3], [], sam=False,
                    path=f"installed_db_{INSTALL_CPU_PAIRS}_pairs")
    cmp_s = time.perf_counter() - t0
    return dict(assemblies=len(asms), installed=len(installed), bp=bp,
                entries=entries, genes=meta_genes, index_keys=n_keys,
                mirror_s=mirror_s, install=runs, parse=parse,
                reads=n_reads, wall_s=wall, loop_s=loop_s, load=load,
                species_share=at_species / INSTALL_PAIRS,
                genus_share=at_genus / INSTALL_PAIRS,
                gene_hits=len(gene_rows), sw_launches=fused,
                join_launches=joins, cpu_compare_s=cmp_s)


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
    from kslam_tpu_torch.ops import cuda_lib, sw_cuda

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    record_load_peaks()
    smi = nvidia_smi_line()
    log(f"phase 1 device: {name}; nvidia-smi: {smi}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        cuda_build = pool.submit(cuda_lib.load_library)
        host_build = pool.submit(native.get_lib)
        lib_path = cuda_build.result()._name
        host_lib = host_build.result()
    log(f"phase 2 build: the CUDA kernel library (SW, join and SAM kernels, "
        f"one nvcc per source) and the native host library built in "
        f"{time.perf_counter() - t0:.1f} s (in parallel)")
    for func, info in ptxas_report(cuda_lib.BUILD_LOG):
        log(f"  ptxas: {func}: {info}")
    rows = sw_cuda.launch_config(32768, 160, 192).rows
    for kname, align in (("sw_forward", False), ("sw_align", True)):
        loops = sass_step_loops(lib_path, rows, align)
        if not loops:
            log(f"  {kname} SASS instructions per cell: not measured (no "
                f"cuobjdump, or no step loop found)")
            continue
        for n_ins, ops in loops:
            log(f"  {kname} SASS step loop at the main path's R={rows}: "
                f"{n_ins} instructions for {rows} cells, "
                f"{n_ins / rows:.2f} per cell; {dict(ops.most_common())}")
    log(f"  native host library: {native.BUILD_REPORT}")
    if host_lib is None:
        raise AssertionError("the native host library is absent: "
                             f"{native.BUILD_REPORT}")

    rng = np.random.default_rng(args.seed)
    log("phase 3 kernels vs their plain versions on the card")
    err, ms, plain_ms, bound = phase_kernel(rng, dev)
    # generators of their own: phases 4-5 draw their data from rng alone
    align = phase_align(np.random.default_rng(args.seed + 1), dev)
    phase_join_kernels(np.random.default_rng(args.seed + 2), dev)
    sam_lines = phase_sam_kernels(np.random.default_rng(args.seed + 3), dev)
    # the fused launches of the 1.6 Gbp runs: one per batch of 32,768
    # candidates
    expect = 4 if (args.mbp, args.pairs) == (1600, 131072) else None

    with tempfile.TemporaryDirectory(prefix="kslam_smoke_") as tmp:
        log("phase 4 CLI cuda vs cpu on a small DB")
        small_launches = phase_e2e_small(rng, tmp)
        log(f"phase 5 real size: {args.mbp} Mbp DB, {args.pairs} pairs")
        launches, fused, cells, ctx = phase_real(rng, tmp, args.mbp,
                                                 args.pairs, expect)
        log(f"phase 6 real-size SAM: {args.pairs} pairs")
        sam_launches, sam_kernel_launches = phase_sam(ctx, tmp)
        log(f"phase 7 host-object path (--device-pipeline off): "
            f"{args.host_pairs} pairs")
        if args.host_pairs < args.pairs:
            log(f"  depth cut: {args.host_pairs} of the {args.pairs} pairs "
                f"(the host-object pairing is Python)")
        _, align_launches = phase_host_path(
            ctx, tmp, min(args.host_pairs, args.pairs))
        ctx_sam_output, ctx_checked = ctx["sam_output_s"], ctx["sam_checked"]
        log(f"phase 8 real-size mesh (--mesh 2x2 --shard-genomes): "
            f"{args.pairs} pairs")
        mesh_launches, mesh_fused, mesh_cells = phase_mesh(ctx, tmp,
                                                           expect=expect)
        log(f"phase 8 real-size mesh SAM (--mesh 2x2 --shard-genomes "
            f"--sam-file): {args.pairs} pairs")
        phase_mesh_sam(ctx, tmp)
        # 4 chunks at any --pairs, so that the depths can differ
        chunk_pairs = max(args.pairs // 4, 1)
        log(f"phase 9 chunk pipeline: {args.pairs} pairs in chunks of "
            f"{chunk_pairs} pairs, depths 1 and 3 in turns")
        pipe_fused = phase_pipeline(ctx, tmp, chunk_pairs, expect)
        log(f"phase 10 join backends: phase 5's DB and its "
            f"{2 * args.pairs} reads' k-mers at once")
        joins = phase_join(ctx, tmp, dev, args.seed)
        log(f"  join: {json.dumps({'join': joins})}")
        log(f"phase 11 DB provisioning: a local NCBI mirror of "
            f"{INSTALL_ASSEMBLIES} bacterial assemblies, "
            f"kslam_tpu_torch.install_db twice, the parsers at "
            f"{PARSE_MBP} Mbp, {INSTALL_PAIRS} pairs on the installed DB")
        installed = phase_install(np.random.default_rng(args.seed + 11),
                                  tmp, args.seed)
        log(f"  install: {json.dumps({'install': installed})}")

    flat, chunked = align["flat"], align["chunked"]
    kernels = {"kernels": [{
        "name": "sw_forward", "route": "cuda",
        "source": "kslam_tpu_torch/csrc/sw_forward.cu",
        "replaces": "kslam_tpu/ops/sw_pallas.py:163",
        # every path now launches the fused sw_align instead
        "launches": launches - fused,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1],
        "bound_share": bound[0] / ms, "library_ms": None}, {
        "name": "sw_align", "route": "cuda",
        "source": "kslam_tpu_torch/csrc/sw_forward.cu",
        "replaces": "kslam_tpu/ops/sw_pallas.py:188",
        "launches": fused,
        "launches_by_path": {"device_pipeline": fused,
                             "sam": sam_launches,
                             "flat_window": align_launches,
                             "mesh_2x2_shard_genomes": mesh_fused,
                             "chunk_pipeline": pipe_fused,
                             "installed_db": installed["sw_launches"],
                             **{f"small_{k}": v
                                for k, v in small_launches.items()}},
        "rectangle_cells_main_path": cells,
        "rectangle_cells_mesh_path": mesh_cells,
        "max_abs_err": align["max_abs_err"], "ms": flat["ms"],
        "composition_ms": flat["composition_ms"],
        "plain_ms": flat["plain_ms"], "bound_ms": flat["bound_ms"],
        "bound_by": flat["bound_by"], "bound_share": flat["bound_share"],
        "composition_bound_share": flat["composition_bound_share"],
        "cells_needed": flat["cells_needed"],
        "cells_computed": flat["cells_computed"],
        "cells_rectangle": flat["cells_rectangle"],
        "shape": "B=32768 Lq=Lr=160 (flat window)",
        "chunked": chunked, "library_ms": None}]}
    kernels["kernels"] += join_kernel_entries(joins)
    for line in sam_lines:
        kernel = line["name"]
        kernels["kernels"].append(dict(
            line, launches=sam_kernel_launches[kernel],
            launches_by_path={p: v[kernel] for p, v in SAM_PATHS.items()},
            phase6_ms=[t[f"{kernel}_ms"] for t in RUN_TIMES
                       if f"{kernel}_ms" in t],
            phase6_alignments=[t["alignments"] for t in RUN_TIMES],
            sam_output_s=ctx_sam_output, checked=ctx_checked))
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
