"""Device milliseconds of the fused SW kernel (sw_group_kernel, the
sw_align launch) in the traced window, per million reads completed."""


def read(run):
    if run.trace is None or run.win is None:
        return None
    ks = run.trace.kernels("sw_group_kernel", *run.win)
    if not ks:
        return None
    return 1e3 * sum(d for _, d in ks) / run.mreads
