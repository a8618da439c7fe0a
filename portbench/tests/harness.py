"""Drive a whole run of the tiny configuration on a device (the CPU in
the tests), skipping the harness's look for a card."""

import json
import tempfile
import types

import torch

from portbench import registry, run as R
from portbench.tests import tiny


def tiny_run(seed: int = 7, traffic: str = "shotgun", seconds: float = 2.0,
             control: str = "none", trace: int = 0, device="cpu",
             sam: bool = False, cfg: dict = None):
    bench = registry.benchmark()
    cell = {"name": "tiny", "config": "tiny", "traffic": traffic,
            "chips": 1}
    bench = dict(bench, end_to_end=[dict(m, workloads=["tiny"])
                                    for m in bench["end_to_end"]],
                 per_layer=[dict(m, workloads=["tiny"])
                            for m in bench["per_layer"]])
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace,
                                 control=control)
    with tempfile.TemporaryDirectory() as work:
        return R.run_cell(args, bench, cell, cfg or tiny.config(sam),
                          tiny.traffic(traffic), torch.device(device), work,
                          cache=CACHE.name)


# one database cache for the tests of a process, outside the checkout
CACHE = tempfile.TemporaryDirectory()


def last_line(result: dict) -> dict:
    return json.loads(json.dumps(result))
