"""The harness: data-driven lookup, the result line, the import rules and
the sector_join byte count."""

import ast
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

from portbench import registry
from portbench.tests.harness import tiny_run

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)
FORBIDDEN = {"jax", "jaxlib", "flax", "kslam_tpu"}


def _imports(path):
    """Top-level names of every module a file imports (whole names)."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _py_files(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _py_files(PKG):
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in _py_files(os.path.join(PKG, "reference")):
        assert not _imports(path) & (FORBIDDEN | {"kslam_tpu_torch"}), path


def test_a_run_loads_no_jax():
    """What the harness loads on the card, in one process: nothing whose
    top-level name is jax, jaxlib, flax or kslam_tpu."""
    code = ("import sys; import portbench.run, portbench.window, "
            "portbench.reference.chunk, portbench.trace; "
            "from portbench import registry; "
            "[registry.reader(m['name']) for k in ('end_to_end', "
            "'per_layer') for m in registry.benchmark()[k]]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True).stdout
    assert not set(eval(out)) & FORBIDDEN


def test_new_config_traffic_and_metric_found_without_edits(tmp_path):
    """A cell that adds a configuration, a mix and a metric as new files
    (and BENCHMARK.json entries) is found by name; no file changes."""
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache"))
    before = {p: open(p, "rb").read() for p in _py_files(str(pkg))}
    bench = registry.benchmark()
    (pkg / "configs" / "new-cfg.json").write_text(json.dumps({"k": 32}))
    (pkg / "traffic" / "new-mix.json").write_text(json.dumps({"pairs": 9}))
    (pkg / "metrics" / "new_metric.x.py").write_text(
        "def read(run):\n    return run.rate_per_min * 2\n")
    bench["configs"].append({"name": "new-cfg", "source": "s",
                             "file": "portbench/configs/new-cfg.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "new-cfg.new-mix",
                               "config": "new-cfg", "traffic": "new-mix",
                               "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "new_metric.x", "unit": "x",
                               "better": "higher", "source": "host_clock",
                               "layer": "L", "moves": "reads_per_min",
                               "workloads": ["new-cfg.new-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    b = registry.benchmark(str(tmp_path))
    cell = registry.cell(b, "new-cfg.new-mix")
    assert registry.config(b, cell["config"], str(tmp_path)) == {"k": 32}
    assert registry.traffic(cell["traffic"], str(pkg)) == {"pairs": 9}
    names = [m["name"] for m in registry.metrics_of(b, cell["name"], True)]
    assert names == ["new_metric.x"]

    class R:
        rate_per_min = 21.0
    assert registry.reader("new_metric.x", str(pkg))(R) == 42.0
    after = {p: open(p, "rb").read() for p in before}
    assert after == before


def test_result_line_has_the_contract_keys():
    res = tiny_run(seed=11, seconds=1.5)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "compared"]
    assert res["correct"] is True
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    names = {m["name"] for m in registry.benchmark()["end_to_end"]}
    assert {"setup_s", "reads_per_min", "peak_mem_gib"} <= set(
        res["metrics"]) <= names
    json.dumps(res)


def _brute_bytes(q, q_ok, keys, bits, mod):
    rows_of_keys = mod.row_of(keys, bits).tolist()
    rows = mod.row_of(q, bits).tolist()
    kl = keys.tolist()
    t = [((k ^ mod.FLIP) >> 32) & mod.U32 for k in kl]
    total = len(rows) * 24 + len(set(rows)) * 32
    probed = set()
    for i, r in enumerate(rows):
        run = [j for j, rr in enumerate(rows_of_keys) if rr == r]
        esc = len(run) > 4 or (len(run) > 0 and
                               t[run[min(len(run), 4) - 1]] - t[run[0]]
                               >= 4096)
        if not esc:
            continue
        total += 1
        if not q_ok[i]:
            continue
        a, b = run[0], run[-1] + 1
        x = int(q[i])
        for upper, lo in ((False, a), (True, None)):
            lo_ = a if lo is not None else found
            hi_ = b
            while lo_ < hi_:
                mid = lo_ + (hi_ - lo_) // 2
                probed.add(mid)
                if (kl[mid] <= x) if upper else (kl[mid] < x):
                    lo_ = mid + 1
                else:
                    hi_ = mid
            found = lo_
    return total + 8 * len(probed)


def test_sector_join_bytes_equal_a_brute_force_count():
    mod = registry.roofline("sector_join")
    g = torch.Generator().manual_seed(3)
    # a few hundred keys crowded into few rows (escapes, long runs, far
    # t-deltas) plus spread ones
    base = torch.randint(-2**62, 2**62, (40,), generator=g)
    keys = torch.cat([base, base[:8].repeat(6) + torch.randint(
        0, 1 << 40, (48,), generator=g), base[:3].repeat(4)])
    keys = torch.sort(keys).values
    q = torch.cat([keys[torch.randint(0, len(keys), (300,), generator=g)],
                   torch.randint(-2**62, 2**62, (100,), generator=g)])
    q_ok = torch.rand(len(q), generator=g) < 0.8
    bits = 6
    got = mod.join_bytes(q, q_ok, keys, mod.row_of(keys, bits), bits)
    assert got == _brute_bytes(q, q_ok.tolist(), keys, bits, mod)
    assert mod.default_bits(10**8) == 27 and mod.default_bits(10) == 21


def test_row_of_matches_the_cdf_map():
    mod = registry.roofline("sector_join")
    words = np.random.default_rng(1).integers(0, 2**63, 1000,
                                              dtype=np.uint64) * 2 + 1
    keys = torch.as_tensor((words ^ np.uint64(1 << 63)).view(np.int64))
    bits = 21
    for w, r in zip(words.tolist(), mod.row_of(keys, bits).tolist()):
        t = w >> 32
        v = 2 * t - (t * t >> 32)
        assert r == min(v >> (32 - bits), (1 << bits) - 1)


def test_trace_busy_is_the_union_a_card_averaged_over_cards(tmp_path):
    from portbench.trace import Trace

    def op(ts, dur, card):
        return {"cat": "kernel", "name": "k", "ts": ts, "dur": dur,
                "args": {"device": card}}
    events = [op(0, 10, 0), op(5, 10, 0), op(30, 10, 0),     # 25 us busy
              op(0, 5, 1),                                   # 5 us busy
              {"cat": "user_annotation", "name": "portbench.anchor",
               "ts": 0}]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    trace = Trace(str(path), 0.0, [])
    assert trace.busy_s(0, 100) == (25 + 5) / 2 / 1e6
    assert trace.busy_s(8, 35) == (12 + 0) / 2 / 1e6
