"""Seconds of the port's DB load (TaxonomyDB.read_index,
GenbankIndex.load, KmerIndex.load, DeviceDB.from_index,
run.device_tables), each synced."""


def read(run):
    return sum(run.load_s.values())
