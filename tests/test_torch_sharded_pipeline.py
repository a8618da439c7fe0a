"""kslam_tpu_torch's chunk pipeline on a (data, index) mesh
(pipeline/run.process_chunk with parallel/dist's sharded phase A) against
kslam_tpu's: the surviving pairs of the host object model
(chunk_to_host_pairs), their overlaps and the per-read LCAs must equal
the reference's mesh run (8-virtual-device CPU mesh) and its
single-device run, exactly.  Fixture of tests/test_sharded_pipeline.py;
the port's mesh cells all live on the CPU."""

import numpy as np
import pytest
import torch

from kslam_tpu.config import PipelineConfig as JConfig
from kslam_tpu.io.fastq import ReadBatch as JReadBatch
from kslam_tpu.pipeline import run as jrun
from kslam_tpu_torch.config import PipelineConfig
from kslam_tpu_torch.db.kmer_index import KmerIndex
from kslam_tpu_torch.io.fastq import ReadBatch
from kslam_tpu_torch.ops import lca
from kslam_tpu_torch.parallel import dist
from kslam_tpu_torch.pipeline import run
from tests.test_sharded_pipeline import (  # noqa: F401
    _mesh_and_db, _summarize, setup)

torch.set_num_threads(1)


def _single_end(batch, cls):
    return cls(names=batch.names[:40], bases=batch.bases[:40],
               lengths=batch.lengths[:40], quality=batch.quality[:40],
               paired=False)


def _jax_config(gshard=False, read_batch=32):
    return JConfig(read_batch=read_batch, max_matches_per_kmer=16,
                   max_pairs_per_batch=1 << 12, sw_batch=1 << 10,
                   genome_sharded=gshard)


@pytest.fixture(scope="module")
def port(setup):  # noqa: F811
    """The fixture's batch, index and tables as port objects."""
    taxdb, gindex, kidx, _, batch, _, _ = setup
    tbatch = ReadBatch(names=batch.names, bases=batch.bases,
                       lengths=batch.lengths, quality=batch.quality,
                       paired=True)
    tkidx = KmerIndex(kidx.kmers, kidx.entry_id, kidx.offset, kidx.rc)
    entry_taxids = torch.as_tensor(gindex.taxonomy_ids.astype(np.int64))
    return tbatch, tkidx, entry_taxids, lca.build_device_tables(taxdb, "cpu")


@pytest.fixture(scope="module")
def jax_single(setup):  # noqa: F811
    """The reference's single-device results, paired and single-end."""
    taxdb, gindex, kidx, db, batch, entry_taxids, lca_tables = setup
    paired = jrun.process_batch_device(batch, db, _jax_config(),
                                       entry_taxids, lca_tables)
    single = jrun.process_batch_device(
        _single_end(batch, JReadBatch), db, _jax_config(read_batch=16),
        entry_taxids, lca_tables)
    return _summarize(paired), _summarize(single)


def _port_mesh(setup, port, data, index, gshard, paired=True):  # noqa: F811
    _, gindex, _, _, _, _, _ = setup
    tbatch, tkidx, entry_taxids, tables = port
    if not paired:
        tbatch = _single_end(tbatch, ReadBatch)
    mesh = dist.build_mesh(["cpu"], data=data, index=index)
    sdb = dist.place_sharded_db(mesh, tkidx, gindex.bases_concat,
                                gindex.entry_offsets, genome_sharded=gshard)
    b, ov_cols = run.process_chunk(
        tbatch, None, PipelineConfig(genome_sharded=gshard), entry_taxids,
        tables, mesh=mesh, sharded_db=sdb)
    return _summarize(run.chunk_objects(b, ov_cols, tbatch))


@pytest.mark.parametrize("gshard", [False, True])
def test_mesh_equals_jax_mesh(setup, port, gshard):  # noqa: F811
    taxdb, gindex, kidx, db, batch, entry_taxids, lca_tables = setup
    mesh, sdb = _mesh_and_db(setup, 2, 4, genome_sharded=gshard)
    want = _summarize(jrun.process_batch_device(
        batch, db, _jax_config(gshard), entry_taxids, lca_tables,
        mesh=mesh, sharded_db=sdb))
    got = _port_mesh(setup, port, 2, 4, gshard)
    assert got == want and len(got) > 30


@pytest.mark.parametrize("data,index,gshard,paired", [
    (2, 4, False, True), (1, 8, False, True), (4, 2, False, True),
    (2, 4, True, True), (1, 8, True, True), (2, 4, False, False)])
def test_mesh_equals_jax_single_device(setup, port, jax_single,  # noqa: F811
                                       data, index, gshard, paired):
    got = _port_mesh(setup, port, data, index, gshard, paired=paired)
    want = jax_single[0 if paired else 1]
    assert got == want and len(got) > 30
