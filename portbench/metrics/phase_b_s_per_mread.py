"""Phase B's stage seconds (insert_model + phase_b) added in the window,
per million reads completed."""


def read(run):
    return run.per_mread("insert_model", "phase_b")
