"""The host tail's stage seconds (result_fetch + taxonomy) added in the
window, per million reads completed."""


def read(run):
    return run.per_mread("result_fetch", "taxonomy")
