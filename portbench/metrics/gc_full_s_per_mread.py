"""Seconds of CPython's full (generation 2) collections inside the
window, per million reads completed (gc.callbacks around the window:
the program's objects, such as each chunk's gene lists, are what they
walk)."""


def read(run):
    return run.gc_s / run.mreads
