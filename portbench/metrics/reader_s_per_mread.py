"""The chunk reader's stage seconds (fastq_parse + pack_reads) added in
the window, per million reads completed."""


def read(run):
    return run.per_mread("fastq_parse", "pack_reads")
