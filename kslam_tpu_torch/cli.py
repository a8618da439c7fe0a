"""Command-line interface of the PyTorch/CUDA port.

Usage:
  python -m kslam_tpu_torch.cli [options] --db=DATABASE --output-file OUT \
      [--sam-file OUT.sam] R1FILE [R2FILE] [--device cuda|cpu] \
      [--mesh DxS [--shard-genomes]] \
      [--coordinator HOST:PORT --num-processes P --process-id N]
  python -m kslam_tpu_torch.cli --build-host-table HOST.fa --output-file D
  python -m kslam_tpu_torch.cli --parse-fasta F.fa [...] --output-file DBDIR
  python -m kslam_tpu_torch.cli --parse-genbank F.gbff [...] --output-file D
  python -m kslam_tpu_torch.cli --parse-taxonomy names.dmp nodes.dmp \
      --output-file DB

The flags and database files are kslam_tpu.cli's, and so are the outputs
(SAM, XML, _PerRead, _abbreviated): on one device, on a --mesh DxS of
devices (parallel/dist.py; --shard-genomes splits the genomes too), and
over processes with --coordinator HOST:PORT --num-processes P
--process-id N, one command per process (parallel/multihost.py).
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import PipelineConfig, SWParams
from .utils.logging import log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="SLAM", add_help=True,
        description="Metagenomic classification on PyTorch/CUDA "
                    "(k-SLAM capabilities)")
    p.add_argument("--db", help="SLAM database directory which reads will "
                                "be aligned against")
    p.add_argument("--min-alignment-score", type=int, default=0,
                   help="alignment score cutoff")
    p.add_argument("--score-fraction-threshold", type=float, default=0.95,
                   help="screen alignments with scores < this*top score")
    p.add_argument("--match-score", type=int, default=2)
    p.add_argument("--mismatch-penalty", type=int, default=3)
    p.add_argument("--gap-open", type=int, default=5)
    p.add_argument("--gap-extend", type=int, default=2)
    p.add_argument("--num-reads", type=int, default=0xFFFFFFFF,
                   help="Number of reads from R1/R2 File to align")
    p.add_argument("--num-reads-at-once", type=int, default=10_000_000,
                   help="Reduce RAM usage by only analysing N reads at once")
    p.add_argument("--output-file", default="")
    p.add_argument("--sam-file", default="")
    p.add_argument("--num-alignments", type=int, default=10,
                   help="Number of alignments to report in SAM file")
    p.add_argument("--sam-xa", action="store_true",
                   help="only output primary alignment lines")
    p.add_argument("--version", action="store_true")
    p.add_argument("--just-align", action="store_true",
                   help="only perform alignments, not metagenomics")
    p.add_argument("--no-pseudo-assembly", action="store_true",
                   help="do not link alignments together")
    p.add_argument("--host-screen", default="",
                   help="directory with a host k-mer table; reads matching "
                        "the host genome are removed before alignment")
    p.add_argument("--low-complexity-cutoff", type=int, default=0,
                   help="flag reads with fewer than N distinct 3-mers")
    p.add_argument("--device-pipeline", choices=("auto", "on", "off"),
                   default="auto",
                   help="full-device batch path (auto: on); off runs the "
                        "host-object path")
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted run from its chunk "
                        "checkpoint (cursor sidecar next to the output)")
    p.add_argument("--no-chunk-overlap", action="store_true",
                   help="run the chunks one after another, with one "
                        "chunk's host and device work in flight (default: "
                        "the next chunk's parse and the last chunk's "
                        "output overlap a chunk's device work)")
    p.add_argument("--no-prefix-rows", action="store_true",
                   help="skip the 2x join-row index copy in HBM (slower "
                        "join, more headroom for huge databases)")
    p.add_argument("--mesh", default="",
                   help="DATAxINDEX device mesh, e.g. 2x4: shard reads "
                        "over the data axis and the k-mer index by range "
                        "over the index axis (results identical to one "
                        "device; cells cycle over the visible devices)")
    p.add_argument("--shard-genomes", action="store_true",
                   help="with --mesh: also partition the genome bases by "
                        "entry range over the index axis (entry-owner SW "
                        "routing; no device holds the whole database)")
    # multi-process (one process per host or card; each process sees the
    # cards CUDA_VISIBLE_DEVICES gives it)
    p.add_argument("--coordinator", default="",
                   help="torch.distributed (gloo) address HOST:PORT; "
                        "process 0 listens there")
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--build-host-table", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--parse-genbank", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--parse-fasta", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--parse-taxonomy", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device of the classification run (no fallback: "
                        "cuda without a card raises)")
    p.add_argument("input_files", nargs="*")
    return p


def config_from_args(args, argv) -> PipelineConfig:
    return PipelineConfig(
        sw=SWParams(args.match_score, args.mismatch_penalty, args.gap_open,
                    args.gap_extend),
        score_threshold=args.min_alignment_score,
        score_fraction_threshold=args.score_fraction_threshold,
        num_sam_alignments=args.num_alignments,
        perform_pseudo_assembly=not args.no_pseudo_assembly,
        sam_xa=args.sam_xa,
        just_align=args.just_align,
        num_reads_at_once=args.num_reads_at_once,
        num_reads=args.num_reads,
        command_line=" ".join(["SLAM"] + argv),
        host_screen_dir=args.host_screen,
        low_complexity_cutoff=args.low_complexity_cutoff,
        resume=args.resume,
        device_pipeline=args.device_pipeline,
        mesh_shape=args.mesh,
        genome_sharded=args.shard_genomes,
        chunk_overlap=not args.no_chunk_overlap,
        prefix_rows=not args.no_prefix_rows,
    )


STREAM_BUILD_BP = 2_000_000_000  # above ~2 Gbp the in-RAM k-mer column
                                 # sort would need tens of GB; spill


def build_database(paths, out_dir: str, from_fasta: bool) -> None:
    # the linear-time GBFF parser (db/gbff.py) in place of the copy's
    from .db.gbff import index_from_gbff
    from .db.genbank import index_from_fasta
    from .db.kmer_index import KmerIndex
    index = index_from_fasta(paths) if from_fasta else index_from_gbff(paths)
    log(f"Parsed {len(index.entries)} entries")
    os.makedirs(out_dir, exist_ok=True)
    index.save(out_dir)
    total_bp = int(index.entry_offsets[-1])
    if total_bp > STREAM_BUILD_BP:
        import numpy as np
        log(f"{total_bp / 1e9:.1f} Gbp database: streaming out-of-core "
            f"index build (bounded RAM, db/kmer_index.build_streamed)")
        kidx = KmerIndex.build_streamed(
            ((i, np.frombuffer(e.bases.encode(), dtype=np.uint8))
             for i, e in enumerate(index.entries)),
            out_dir=out_dir)
    else:
        kidx = KmerIndex.build(index)
        kidx.save(out_dir)
    log(f"Wrote database with {len(kidx)} index k-mers to {out_dir}")


def resolve_device(name: str):
    """The torch device for --device; cuda without a card raises."""
    import torch
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(use --device cpu to run on the CPU)")
    return torch.device(name)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    if args.version:
        print("1.0")
        return 1
    if args.parse_genbank:
        log("Parsing Genbank")
        build_database(args.input_files, args.output_file, from_fasta=False)
        return 0
    if args.parse_fasta:
        log("Parsing FASTA")
        build_database(args.input_files, args.output_file, from_fasta=True)
        return 0
    if args.build_host_table:
        log("Building host lookup table (k = 16)")
        from .db.genbank import index_from_fasta
        from .db.host_table import HostTable
        gindex = index_from_fasta(args.input_files)
        HostTable.build(gindex).save(args.output_file)
        return 0
    if args.parse_taxonomy:
        log("Parsing taxonomy")
        if len(args.input_files) != 2:
            print("Provide names.dmp and nodes.dmp")
            return 1
        from .db.taxonomy import TaxonomyDB
        db = TaxonomyDB.from_dumps(args.input_files[0], args.input_files[1])
        db.write_index(args.output_file)
        return 0
    if not args.input_files:
        build_parser().print_help()
        return 1
    device = resolve_device(args.device)
    config = config_from_args(args, argv)
    r1 = args.input_files[0]
    r2 = args.input_files[1] if len(args.input_files) > 1 else None
    if args.coordinator:
        from .parallel import multihost
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id, device)
        try:
            multihost.metagenomic_analysis_distributed(
                r1, r2, args.db, args.output_file, args.sam_file, config,
                device)
        finally:
            multihost.shutdown()
        return 0
    from .pipeline.run import metagenomic_analysis
    metagenomic_analysis(r1, r2, args.db, args.output_file, args.sam_file,
                         config, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
