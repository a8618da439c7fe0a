"""A tiny configuration and traffic mix for the CPU tests: the cell's
shapes (k, stride, read length, inserts, repeats) at a scale the CPU
runs in seconds."""

import copy
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(sam: bool = False) -> dict:
    with open(os.path.join(HERE, "configs", "bact-1g6.json")) as fh:
        cfg = json.load(fh)
    cfg = copy.deepcopy(cfg)
    cfg["db"].update(genomes=12, genome_bp=120_000, genera=4,
                     is_copies=[1, 2], operon_copies=[1, 2], lc_tracts=[0, 1])
    cfg["pipeline"].update(num_reads_at_once=512, read_batch=512,
                           report_cigar=sam)
    return cfg


def traffic(name: str = "shotgun", pairs: int = 2048) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as fh:
        t = json.load(fh)
    t.update(pairs=pairs, novel_strains=2)
    if t["host_share"]:
        t["host_bp"] = 400_000
    return t
