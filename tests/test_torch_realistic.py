"""The port's realistic genome generator (kslam_tpu_torch.eval.realistic)
against the reference package's (kslam_tpu.eval.realistic): the same
entries, GBFF dicts, taxa and pileup statistics for a seed."""

import dataclasses

import numpy as np
import pytest

from kslam_tpu.eval import realistic as jreal
from kslam_tpu_torch.eval import realistic


@pytest.mark.parametrize("n_genomes,bp_each,seed", [(3, 60_000, 0),
                                                    (2, 30_000, 7)])
def test_realistic_entries_equal_the_reference(n_genomes, bp_each, seed):
    mine = realistic.make_realistic_entries(n_genomes, bp_each, seed=seed,
                                            plasmid_bp=8_000)
    theirs = jreal.make_realistic_entries(n_genomes, bp_each, seed=seed,
                                          plasmid_bp=8_000)
    assert len(mine) == len(theirs) == n_genomes + (n_genomes + 1) // 2
    for a, b in zip(mine, theirs):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y, f.name
    assert mine[0].seq.dtype == np.uint8 and len(mine[0].seq) == bp_each
    assert realistic.entries_to_gbff_dicts(mine) == \
        jreal.entries_to_gbff_dicts(theirs)
    assert realistic.realistic_taxa(mine) == jreal.realistic_taxa(theirs)
    kmers = np.sort(np.random.default_rng(seed).integers(
        0, 2**63, 5000, dtype=np.uint64))
    kmers[100:160] = kmers[100]                    # one pileup
    assert realistic.pileup_stats(kmers) == jreal.pileup_stats(kmers)
