"""sector_join's share of its bytes roofline over the traced window: the
bytes its launches' inputs need, each once (roofline/sector_join.py,
counted from the cell's own reads and database), at the HBM rate of
peaks.json, over the launches' device time."""

from portbench.trace import chunk_of


def read(run):
    if run.trace is None or run.win is None:
        return None
    ks = run.trace.kernels("sector_join_kernel", *run.win)
    if not ks:
        return None
    count = run.roofline("sector_join")
    total, secs, seen = 0, 0.0, {}
    for ts, dur in ks:
        chunk = chunk_of(run.trace, "feed", ts)
        if chunk is None:
            return None
        batch = seen.get(chunk, 0)
        seen[chunk] = batch + 1
        total += count.batch_bytes(run, chunk % run.file_chunks, batch)
        secs += dur
    return 100.0 * total / run.peaks["hbm_bytes_per_s"] / secs
