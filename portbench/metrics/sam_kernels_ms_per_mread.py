"""Device milliseconds of the SAM kernels (the passes kernel, sam_band,
sam_diff, sam_cigar_long) in the traced window, per million reads
completed.  SAM cells only."""

KERNELS = ("sam_pass_kernel", "sam_band_kernel", "sam_diff_kernel",
           "sam_cigar_long_kernel")


def read(run):
    if not run.sam or run.trace is None or run.win is None:
        return None
    ms = sum(d for k in KERNELS for _, d in run.trace.kernels(k, *run.win))
    return 1e3 * ms / run.mreads if ms else None
