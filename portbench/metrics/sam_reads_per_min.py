"""reads_per_min of a run that also writes SAM (--sam-file)."""


def read(run):
    return run.rate_per_min if run.sam else None
