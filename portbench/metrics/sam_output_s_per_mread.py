"""The SAM text's stage seconds (sam_output) added in the window, per
million reads completed.  SAM cells only."""


def read(run):
    return run.per_mread("sam_output") if run.sam else None
