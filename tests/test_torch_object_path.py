"""The host-object pieces of kslam_tpu_torch against the JAX reference:
the flat-window SW (ops/sw.align_overlaps_batch), align_batch_to_database,
process_batch (--device-pipeline off) and chunk_to_host_pairs (the SAM
object model of the device pipeline).  Fixture as
tests/test_device_path.py; integer outputs, exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kslam_tpu.config import PipelineConfig
from kslam_tpu.ops import lca as jlca, sw as jsw
from kslam_tpu.pipeline import align as jalign, device_path as jdp, \
    run as jrun
from kslam_tpu_torch.ops import lca, sw
from kslam_tpu_torch.pipeline import align, device_path, run
from tests.test_torch_device_path import _max_insert, _phase_a_both, \
    _single, setup  # noqa: F401  (setup is a fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dbs(setup):  # noqa: F811
    taxdb, gindex, kidx, _, _, batch = setup
    return (jalign.DeviceDB.from_index(gindex, kidx, prefix_rows=False),
            align.DeviceDB.from_index(gindex, kidx, "cpu", flat_scodes=True))


def test_flat_window_sw_matches_jax():
    """RC rows, windows clipped at the entry end, rel_pos < 0, N bases
    and padded reads; the JAX function on its XLA backend."""
    rng = np.random.default_rng(4)
    genome = rng.integers(0, 4, 3000).astype(np.uint8)
    genome[rng.random(3000) < 0.01] = 4
    offsets = np.array([0, 1000, 1700, 3000], np.int64)
    n_reads, l, b = 12, 72, 64
    reads = np.full((n_reads, l), 4, np.uint8)
    lens = rng.integers(40, l + 1, n_reads).astype(np.int32)
    read_id = rng.integers(0, n_reads, b).astype(np.int32)
    entry = rng.integers(0, 3, b).astype(np.int32)
    rel = rng.integers(-30, 1000, b).astype(np.int32)
    rc = rng.random(b) < 0.5
    starts = rng.integers(0, 250, n_reads)
    for i in range(n_reads):      # read i from entry i % 3, odd i RC
        s = int(offsets[i % 3]) + int(starts[i])
        seg = genome[s:s + lens[i]]
        if i % 2:
            seg = np.where(seg < 4, seg ^ 2, seg)[::-1]
        reads[i, :lens[i]] = seg
    for k in range(0, b, 3):      # every third row at its true position
        i = int(read_id[k])
        entry[k], rel[k], rc[k] = i % 3, starts[i], i % 2 == 1
    entry[:4], rel[:4] = 1, [-20, 690, 699, 650]   # clipped windows
    args = (read_id, entry, rel, rc, np.ones(b, bool), reads, lens, genome,
            offsets)
    jout = jsw.align_overlaps_batch(*(jnp.asarray(x) for x in args),
                                    2, 3, 5, 2, window_len=l, backend="xla")
    out = sw.align_overlaps_batch(*(torch.as_tensor(x) for x in args),
                                  2, 3, 5, 2, window_len=l)
    for a, j in zip(out, jout):
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
    assert int(out.score.max()) > 100 and int((out.score == 0).sum()) > 0
    assert bool((rc & (out.score.numpy() > 100)).any())


def _overlap_fields(o):
    return None if o is None else (
        o.read_id, o.entry_id, o.rel_pos, o.rc, o.score, o.ref_begin,
        o.ref_end, o.query_begin, o.query_end, o.cigar)


def _read_fields(reads):
    return [(r.r1_pos, r.r2_pos, getattr(r, "device_lca", None),
             [(p.combined_score, p.entry_id, p.ref_start, p.ref_end,
               p.insert_size, _overlap_fields(p.r1), _overlap_fields(p.r2))
              for p in r.pairs]) for r in reads]


@pytest.mark.parametrize("paired", [True, False])
def test_align_batch_to_database_matches_jax(setup, dbs, paired):  # noqa: F811
    batch = setup[5] if paired else _single(setup[5])
    config = PipelineConfig(score_threshold=250)
    jdb, tdb = dbs
    ref = jalign.align_batch_to_database(batch, jdb, config)
    got = align.align_batch_to_database(batch, tdb, config)
    assert [_overlap_fields(o) for o in got] == \
        [_overlap_fields(o) for o in ref]
    assert len(got) >= batch.num_reads // 2


@pytest.mark.parametrize("paired", [True, False])
def test_process_batch_matches_jax(setup, dbs, paired):  # noqa: F811
    batch = setup[5] if paired else _single(setup[5])
    jdb, tdb = dbs
    config = PipelineConfig()
    got = _read_fields(run.process_batch(batch, tdb, config))
    assert got == _read_fields(jrun.process_batch(batch, jdb, config))
    assert len(got) == batch.midpoint


@pytest.mark.parametrize("paired", [True, False])
def test_chunk_to_host_pairs_matches_jax(setup, paired):  # noqa: F811
    taxdb, gindex = setup[:2]
    ja, ta = _phase_a_both(setup, paired, packed=True)
    max_insert = min(_max_insert(ta), 2**32 - 1) if paired else 2**32 - 1
    mid = setup[5].midpoint if paired else 0
    n_units = setup[5].midpoint
    jb, jov = jdp.run_chunk_phase_b_exact(
        [ja], mid, mid, n_units, np.uint32(max_insert),
        jnp.asarray(gindex.taxonomy_ids.astype(np.int32)),
        jlca.build_device_tables(taxdb), fraction=0.95,
        perform_pseudo_assembly=True, paired=paired)
    tb, tov = device_path.run_chunk_phase_b(
        [ta], mid, mid, n_units, max_insert,
        torch.as_tensor(gindex.taxonomy_ids.astype(np.int64)),
        lca.build_device_tables(taxdb, "cpu"), fraction=0.95,
        perform_pseudo_assembly=True, paired=paired)
    j_reads, j_lcas = jdp.chunk_to_host_pairs(jb, jov, mid)
    t_reads, t_lcas = device_path.chunk_to_host_pairs(tb, tov, mid)
    assert _read_fields(t_reads) == _read_fields(j_reads)
    assert t_lcas == j_lcas and len(t_reads) == n_units
    assert any(p.r1 is not None and (p.r2 is not None or not paired)
               for r in t_reads for p in r.pairs)


def test_cigar_golden_fallback_matches_native(setup, dbs, monkeypatch):  # noqa: F811
    """SAM cigars from the per-overlap golden model (the path taken
    without the native library) equal the native batch's."""
    from kslam_tpu_torch.io import native
    taxdb, gindex = setup[:2]
    batch = setup[5]
    config = PipelineConfig()
    cigars = []
    for use_native in (True, False):
        if not use_native:
            monkeypatch.setattr(native, "ssw_cigar_batch",
                                lambda *a, **k: None)
        reads = run.process_batch(batch, dbs[1], config)
        run._fill_cigars(reads, batch, gindex, config)
        cigars.append([(o.read_id, o.cigar) for r in reads for p in r.pairs
                       for o in (p.r1, p.r2) if o is not None])
    assert cigars[0] == cigars[1]
    assert len(cigars[0]) >= batch.num_reads and \
        all(c is not None for _, c in cigars[0])
