"""Seconds of phase B's host chain rescoring (the program's
phase_b_rescore spans, device_path.rescore_chains: the fetches, the
rescoring and the upload of the new scores) in the traced window, per
million reads completed."""

from portbench.program_spans import seconds_per_mread


def read(run):
    return seconds_per_mread(run, "phase_b_rescore")
