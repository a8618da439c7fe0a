"""The share of the reader's wall time that its thread spent off the
CPU: 100 x (1 - thread CPU time / wall time) over the program's `read`
root spans in the traced window (a span cut by the window counts its
CPU time pro rata)."""

from portbench.program_spans import in_window


def read(run):
    got = in_window(run)
    if got is None:
        return None
    wall = cpu = 0.0
    for a, b, s in got:
        if s.name != "read" or s.end <= s.start:
            continue
        share = (b - a) / 1e6 / (s.end - s.start)
        wall += (b - a) / 1e6
        cpu += (s.cpu_end - s.cpu_start) * share
    return 100.0 * (1.0 - cpu / wall) if wall else None
