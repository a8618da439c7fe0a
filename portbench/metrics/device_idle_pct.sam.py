"""device_idle_pct of a SAM cell's traced window."""


def read(run):
    if not run.sam or run.trace is None or run.win is None:
        return None
    lo, hi = run.win
    return 100.0 * (1.0 - run.trace.busy_s(lo, hi) / ((hi - lo) / 1e6))
