"""Reads (both mates) classified per minute over the window, by the host
clock: the reads of the chunks whose tails completed in the window over
its length.  Classification cells only."""


def read(run):
    return None if run.sam else run.rate_per_min
