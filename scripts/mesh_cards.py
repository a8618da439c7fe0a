"""chip_smoke.py's real-size mesh run (its phase 8) on every visible card.

    python3 scripts/mesh_cards.py [--seed N] [--mbp 1600] [--pairs 131072]
                                  [--shapes 2x2,1x4]

Builds the CUDA kernel library and the native host library, then chip_smoke.py's
phase 5: the 1.6 Gbp synthetic DB, the planted read pairs and their
single-device classification on cuda:0.  Then, for each mesh shape, the
same reads with --mesh SHAPE --shard-genomes, the cells cycled over the
visible cards: each run's XML, _PerRead and _abbreviated files must be
byte-identical to the single-device run's, and it prints its stage
seconds, the peak memory of every card and the mesh cells on each.
Last, the first --mp-pairs pairs in chunks of half of them through two
--coordinator processes, each given half of the cards by
CUDA_VISIBLE_DEVICES (so each runs a local mesh over its cards when it
has more than one), against the same run on one device.  Run it on a
machine with several cards (one card works too: everything then shares
it).  Exits non-zero if a run fails or differs.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mbp", type=int, default=1600)
    ap.add_argument("--pairs", type=int, default=131072)
    ap.add_argument("--shapes", default="2x2,1x4")
    ap.add_argument("--mp-pairs", type=int, default=16384)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("mesh_cards: no CUDA device", file=sys.stderr)
        return 1
    from kslam_tpu_torch.io import native
    from kslam_tpu_torch.ops import cuda_lib
    chip_smoke.log(f"cards: {torch.cuda.device_count()} x "
                   f"{torch.cuda.get_device_name(0)}; nvidia-smi: "
                   f"{chip_smoke.nvidia_smi_line()}")
    cuda_lib.load_library()
    chip_smoke.record_load_peaks()
    if native.get_lib() is None:
        raise AssertionError(f"no native host library: "
                             f"{native.BUILD_REPORT}")
    rng = np.random.default_rng(args.seed)
    with tempfile.TemporaryDirectory(prefix="kslam_mesh_") as tmp:
        chip_smoke.log(f"single device (chip_smoke.py phase 5): "
                       f"{args.mbp} Mbp DB, {args.pairs} pairs")
        *_, ctx = chip_smoke.phase_real(rng, tmp, args.mbp, args.pairs)
        for shape in args.shapes.split(","):
            chip_smoke.log(f"mesh {shape} --shard-genomes over "
                           f"{torch.cuda.device_count()} card(s)")
            chip_smoke.phase_mesh(ctx, tmp, shape)
        n = torch.cuda.device_count()
        half = max(n // 2, 1)
        visible = [",".join(str(i) for i in range(half)),
                   ",".join(str(i % n) for i in range(half, 2 * half))]
        chip_smoke.log(f"two processes, cards {visible}: {args.mp_pairs} "
                       f"pairs in chunks of {args.mp_pairs // 2}")
        flags = ["--num-reads", str(args.mp_pairs), "--num-reads-at-once",
                 str(args.mp_pairs // 2)]
        ref = os.path.join(tmp, "mp_reference")
        chip_smoke.run_cli(ctx["db"], ref, ctx["r1"], ctx["r2"], "cuda",
                           flags + ["--sam-file", ref + ".sam"])
        chip_smoke.run_two_processes(
            tmp, ctx["db"], ctx["r1"], ctx["r2"], flags,
            chip_smoke.read_outputs(ref, sam=True), name="mp_cards",
            visible=visible,
            join_kernel="window_join" if half > 1 else "sector_join")
    chip_smoke.log("mesh_cards: every mesh and two-process run equals its "
                   "single-device run")
    return 0


if __name__ == "__main__":
    sys.exit(main())
