"""Seconds from the process's start to the window's: the database made
and written, the port's load, the warm-up chunks (and, in a checkout's
first run, the kernels' build)."""


def read(run):
    return run.setup_s
