"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control sw8]

Set-up (setup_s, from the process's start to the window's):
  1. the configuration's database made on the card from the seed
     (gen/genomes.py) and its k-mer index sorted there (gen/index.py);
  2. the database written in the port's format under $TMPDIR
     (gen/dbfiles.py), and the cell's FASTQ pair (gen/reads.py);
  3. the port loads it as its CLI does (window.load);
  4. chunks are fed until the pipeline is full (warm_chunks).
The window: chunks through run.ChunkPipeline until a tail completes
--seconds after the last warm-up chunk's; the rate is the reads (both
mates) of the chunks whose tails completed in between over that time.
Then the run's outputs are written once, the program is freed, and the
plain reference (portbench/reference) classifies the chunk drawn from the
seed; check.py compares.

--trace 1 profiles the window (torch.profiler) and reports the cell's
per-layer metrics; --trace 0 its end-to-end ones.  --control sw8 runs
the reference again with Smith-Waterman saturating at 255 and puts it in
the program's place: its taxids of the sampled chunk stand for the
program's _PerRead and _abbreviated lines in every number compared, so
such a run reports `correct` false (the control of `correct`; a measured
run never passes it).  The last line of standard output is one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
# every build and kernel cache the program could use lies in the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(HERE, ".cache", _sub)
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

FORBIDDEN = ("jax", "jaxlib", "flax", "kslam_tpu")
CACHE = os.path.join(HERE, ".cache", "db")


def log(msg: str) -> None:
    print(f"[portbench {time.perf_counter() - T_START:8.2f}s] {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} &
                  set(FORBIDDEN))


class Run:
    """What a metric reader reads (metrics/<name>.py: read(run))."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_mread(self, *stages) -> float:
        return sum(self.stages.get(s, 0.0) for s in stages) / self.mreads


def parse(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("none", "sw8"), default="none")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from . import registry
    from . import window  # noqa: F401  (the program: fails fast without it)
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cfg = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    work = tempfile.mkdtemp(prefix="portbench-")
    try:
        result = run_cell(args, bench, cell, cfg, traffic,
                          torch.device("cuda", 0), work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    found = forbidden_modules()
    if found:
        log(f"modules that must not be loaded: {found}")
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


def db_dir(cfg: dict, cache: str) -> str:
    """The configuration's database directory in the cache: one a
    configuration, named by its name and a digest of what draws it."""
    import hashlib
    key = json.dumps([cfg["db"], cfg["genome_stride"]], sort_keys=True)
    return os.path.join(cache, f"{cfg['name']}-"
                        f"{hashlib.sha1(key.encode()).hexdigest()[:12]}")


def generate(cfg: dict, traffic: dict, seed: int, device, work: str,
             cache: str):
    """Steps 1-2 of the set-up: the configuration's database (made from
    its db_seed and written into the cache by the checkout's first run,
    found there by later ones) and the cell's FASTQ pair from the seed.
    Returns (database directory, FASTQ paths, r1, r2 host arrays)."""
    import numpy as np
    import torch
    from .gen import dbfiles, genomes, index, reads
    root = db_dir(cfg, cache)
    t = time.perf_counter()
    if os.path.exists(os.path.join(root, "complete")):
        db = genomes.layout(cfg["db"])
        with np.load(os.path.join(root, "genomes.npz")) as g:
            db["bases"] = torch.as_tensor(g["bases"]).to(device)
        log(f"database found in the cache: {time.perf_counter() - t:.2f} s")
    else:
        db = genomes.make_db(cfg["db"], cfg["db"]["db_seed"], device)
        log(f"genomes {int(db['offsets'][-1])} bp, {len(db['taxids'])} "
            f"entries: {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        idx = index.build(db["bases"], db["offsets"], cfg["genome_stride"])
        log(f"index {len(idx[0])} k-mers: {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        part = root + ".partial"
        shutil.rmtree(part, ignore_errors=True)
        dbfiles.write_db(part, db, idx)
        del idx
        open(os.path.join(part, "complete"), "w").close()
        os.rename(part, root)
        log(f"database written: {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    r1, r2, _, _ = reads.make_reads(db, traffic, seed, device)
    paths = (os.path.join(work, "r1.fq"), os.path.join(work, "r2.fq"))
    reads.write_fastq(paths[0], r1)
    reads.write_fastq(paths[1], r2)
    log(f"reads {r1.shape[0]} pairs made and written: "
        f"{time.perf_counter() - t:.2f} s")
    r1, r2 = r1.cpu().numpy(), r2.cpu().numpy()
    del db
    free_device(device)
    return root, paths, r1, r2


def run_cell(args, bench, cell, cfg, traffic, device, work: str,
             cache: str = CACHE) -> dict:
    import numpy as np
    import torch
    from . import check, registry
    from . import window as W
    config = W.pipeline_config(cfg)
    sam = config.report_cigar
    root, (r1p, r2p), r1_host, r2_host = generate(
        cfg, traffic, args.seed, device, work, cache)
    pairs = int(traffic["pairs"])
    # the program pads a chunk's reads to its longest, rounded up to 8
    pad = min(config.max_read_len,
              max(-(-int(traffic["read_bp"]) // 8) * 8, 40))
    chunk = config.num_reads_at_once
    file_chunks = -(-pairs // chunk)
    sample = int(np.random.default_rng([int(args.seed), 3])
                 .integers(file_chunks))
    cards = range(torch.cuda.device_count()) if device.type == "cuda" \
        else ()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    t = time.perf_counter()
    state, load_s = W.load(root, device, config)
    inner = {k: v for k, v in W.stage_seconds().items()
             if k.startswith("db_load_")}
    log(f"load {time.perf_counter() - t:.2f} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in load_s.items())
        + "; of device_db: "
        + ", ".join(f"{k} {v:.3f}" for k, v in inner.items()))
    win = W.Window(state, cfg, config, r1p, r2p, device, args.seconds,
                   file_chunks, sample)
    profiler = None
    if args.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    t_feed = time.perf_counter()
    win.run(profiler)
    prev = {}
    for no, t_, st in win.warm_log:
        log(f"warm-up chunk {no} done at {t_ - t_feed:.2f} s after the "
            f"first feed; stages " + ", ".join(
                f"{k} {v - prev.get(k, 0.0):.2f}" for k, v in st.items()
                if v - prev.get(k, 0.0) >= 0.05))
        prev = st
    # the fullest card's peak (a mesh_shape spreads the run over cards)
    peak = max((torch.cuda.max_memory_allocated(d) for d in cards),
               default=0)
    if win.t_end is None:
        raise RuntimeError("the window never closed: the FASTQ ended")
    setup_s = win.t0 - T_START
    window_s = win.t_end - win.t0
    reads_w = win.window_reads()
    rate = reads_w / window_s * 60.0
    log(f"setup {setup_s:.3f} s; window {window_s:.3f} s, "
        f"{sum(1 for _, t, _ in win.done if win.t0 < t <= win.t_end)} "
        f"chunks, {reads_w} reads, {rate:.1f} reads/min; "
        f"{len(win.fed)} chunks fed; peak {peak} B")
    gaps, gc_s = win.window_chunk_s(), win.window_gc_s()
    log(f"window: full collections {gc_s:.3f} s; "
        f"tail-to-tail s " + " ".join(f"{g:.2f}" for g in gaps))
    trace = None
    if args.trace:
        from .trace import Trace
        path = os.path.join(work, "trace.json")
        profiler.export_chrome_trace(path)
        trace = Trace(path, win.anchor_t, win.spans)
        os.remove(path)
        log(f"trace: {trace.found}")
    out = os.path.join(work, "out")
    t = time.perf_counter()
    win.final_write(out)
    log(f"final write {time.perf_counter() - t:.2f} s")
    stages = win.window_stages()
    instances = sum(1 for no, _, _ in win.done
                    if no % file_chunks == sample)
    pair_total = sum(r for _, _, r in win.done) // 2
    lost = len(win.fed) - len(win.done)
    t0, t_end = win.t0, win.t_end
    del state, win.state
    free_device(device)

    # the reference, on the chunk drawn from the seed
    from .gen import dbfiles, genomes
    from .reference import chunk as ref
    t = time.perf_counter()
    lay = genomes.layout(cfg["db"])
    bases, offsets, index = dbfiles.read_db(root)
    host = dict(bases=bases, offsets=offsets, taxids=lay["taxids"],
                taxonomy=lay["taxonomy"], index=index, r1=r1_host,
                r2=r2_host)
    rdb = ref.ref_db(torch.as_tensor(host["bases"]), host["offsets"],
                     *host["index"], device)
    sw = config.sw
    params = dict(sw=(sw.match, sw.mismatch, sw.gap_open, sw.gap_extend),
                  score_threshold=config.score_threshold,
                  fraction=config.score_fraction_threshold,
                  pseudo_assembly=config.perform_pseudo_assembly, pad=pad)
    lo, hi = sample * chunk, min((sample + 1) * chunk, pairs)
    parent_of = {t_: p for t_, (p, _, _) in host["taxonomy"].items()}
    r1 = torch.as_tensor(host["r1"][lo:hi]).to(device)
    r2 = torch.as_tensor(host["r2"][lo:hi]).to(device)
    stats, detail = {}, ({} if sam else None)
    want = ref.classify(r1, r2, rdb, host["taxids"], parent_of, params,
                        stats=stats, detail=detail)
    log(f"reference: chunk {sample}, {len(want)} of {hi - lo} pairs hit, "
        f"{stats}, {time.perf_counter() - t:.2f} s")
    from .gen.reads import read_names
    names = read_names(pairs)[lo:hi]
    if args.control == "sw8":
        # the control in the program's place: its taxids of the sampled
        # chunk are the _PerRead lines, and its aggregation of them the
        # _abbreviated lines, that the numbers compare
        t = time.perf_counter()
        ctl = ref.classify(r1, r2, rdb, host["taxids"], parent_of, params,
                           control="sw8")
        lines = [(names[i], tx) for i, tx in sorted(ctl.items())]
        instances, pair_total = 1, hi - lo
        abbreviated = check.abbreviated(lines, host["taxonomy"], pair_total)
        log(f"control sw8 in the program's place: "
            f"{time.perf_counter() - t:.2f} s")
    else:
        lines = check.per_read(out + "_PerRead")
        abbreviated = check.lines_of(out + "_abbreviated")
    compared = {
        "taxid_mismatches": check.taxid_mismatches(lines, names, want,
                                                   instances),
        "abundance_mismatches": check.abundance_mismatches(
            abbreviated,
            check.abbreviated(lines, host["taxonomy"], pair_total)),
        "chunks_lost": lost,
    }
    if instances == 0:
        compared["taxid_mismatches"] = hi - lo
    if sam:
        t = time.perf_counter()
        rng = np.random.default_rng([int(args.seed), 4])
        n_sam = min(int(cfg["sam_sample_pairs"]), hi - lo)
        heavy = int(torch.bincount(detail["cols"].group.long()).argmax()) \
            if len(detail["cols"].group) else 0
        checked = sorted(set(rng.choice(hi - lo, n_sam, replace=False)
                             .tolist()) | {heavy})
        compared["sam_line_mismatches"] = check.sam_mismatches(
            win.sam_text, names, checked, detail, host["r1"][lo:hi],
            host["r2"][lo:hi], host["bases"], host["offsets"], params["sw"],
            config.num_sam_alignments)
        log(f"SAM lines of {len(checked)} pairs checked: "
            f"{time.perf_counter() - t:.2f} s")
        del detail
    checks = {k: {"value": v, "limit": check.LIMITS.get(k, 0)}
              for k, v in compared.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    run = Run(rate_per_min=rate, setup_s=setup_s, peak_bytes=peak, sam=sam,
              gc_s=gc_s,
              stages=stages, mreads=reads_w / 1e6, load_s=load_s,
              trace=trace, win=None, host=host, cfg=cfg, config=config,
              cell=cell,
              file_chunks=file_chunks, device=device,
              peaks=registry.peaks(), roofline=registry.roofline,
              warm=int(cfg["warm_chunks"]), pad=pad)
    if trace is not None and trace.offset is not None:
        run.win = (trace.ts(t0), trace.ts(t_end))
    metrics = {}
    for m in registry.metrics_of(bench, cell["name"], bool(args.trace)):
        v = registry.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": sum(
        r for _, r in win.fed), "failed": sum(r for no, r in win.fed)
        - sum(r for _, _, r in win.done), "metrics": metrics,
        "device": dev_info}
    if trace is not None and run.win is not None:
        lo_, hi_ = run.win
        dev_info["busy_s"] = trace.busy_s(lo_, hi_)
        dev_info["window_s"] = (hi_ - lo_) / 1e6
        result["breakdown"] = {"device_ops": trace.top_ops(lo_, hi_),
                               "idle_gaps": trace.idle_gaps(lo_, hi_)}
    result["compared"] = checks
    return result


def free_device(device) -> None:
    """Collect what was dropped and give the card's cached blocks back."""
    import gc
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
