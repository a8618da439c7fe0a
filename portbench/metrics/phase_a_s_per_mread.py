"""Phase A's stage seconds (phase_a, synced) added in the window, per
million reads completed."""


def read(run):
    return run.per_mread("phase_a")
