"""Seconds the calling thread waited for a pending tail (the program's
wait_tail spans, ChunkPipeline._wait) in the traced window, per million
reads completed."""

from portbench.program_spans import seconds_per_mread


def read(run):
    return seconds_per_mread(run, "wait_tail")
