"""100 less the share of the traced window in which some kernel, memcpy
or memset ran (torch.profiler, every stream).  Classification cells."""


def read(run):
    if run.sam or run.trace is None or run.win is None:
        return None
    lo, hi = run.win
    return 100.0 * (1.0 - run.trace.busy_s(lo, hi) / ((hi - lo) / 1e6))
