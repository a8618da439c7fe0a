"""torch.cuda.max_memory_allocated() from the program's load to the
window's end, in GiB."""


def read(run):
    return run.peak_bytes / 2**30
