"""Seconds the calling thread waited for the reader thread's next chunk
(the program's wait_reader spans, ChunkPipeline.read) in the traced
window, per million reads completed."""

from portbench.program_spans import seconds_per_mread


def read(run):
    return seconds_per_mread(run, "wait_reader")
