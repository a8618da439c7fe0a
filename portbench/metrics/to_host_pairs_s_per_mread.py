"""The object model's stage seconds (to_host_pairs) added in the window,
per million reads completed.  SAM cells only."""


def read(run):
    return run.per_mread("to_host_pairs") if run.sam else None
