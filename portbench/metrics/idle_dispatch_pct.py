"""The share of the traced window in which the card runs nothing (no
kernel, memcpy or memset on any stream) while the calling thread's
innermost program span is a device stage (phase_a_seed, phase_a_sw,
phase_a_pair, or phase_b outside phase_b_rescore): the card waiting on
launches and syncs, not on host work."""

from portbench.program_spans import DEVICE_STAGES, exclusive, in_window, \
    minus, union


def read(run):
    got = in_window(run)
    if got is None:
        return None
    lo, hi = run.win
    busy = union((max(a, lo), min(b, hi)) for a, b, _ in run.trace.device
                 if b > lo and a < hi)
    idle = minus(exclusive(got, DEVICE_STAGES), busy)
    return 100.0 * sum(b - a for a, b in idle) / (hi - lo)
