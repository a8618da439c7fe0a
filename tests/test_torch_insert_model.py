"""The port's insert-size model (pipeline/pairing.max_allowed_insert_size_
from_sizes) fed an int64 array, against the JAX package's fed the sorted
Python list: every branch of PairedOverlap.h:300-360 (spikes, quartiles,
upper == 0, nothing kept, a negative variance, both sides of the
count-aware int64 guard) and seeded draws of 10^5 sizes."""

import numpy as np
import pytest

from kslam_tpu.pipeline import pairing as jpairing
from kslam_tpu_torch.pipeline import pairing

U32 = 2**32
TOP = 2**31 - 1


def _draw(seed, outliers):
    rng = np.random.default_rng(seed)
    sizes = rng.normal(350, 60, 100_000).astype(np.int64)
    if outliers:
        sizes[rng.integers(0, len(sizes), 700)] = \
            rng.integers(TOP - 100_000, TOP, 700)
    return sizes[sizes != 0]


CASES = {
    "empty": [],
    "one": [417],
    "all_equal": [250] * 1000,
    "spike": [300 + i % 50 for i in range(900)] +
             [50_000 + i for i in range(100)],
    "no_spike": list(np.random.default_rng(5).normal(350, 40, 5000)
                     .astype(np.int64)),
    "upper_zero": [-3] * 30 + [-2] * 50 + [5] * 20,
    "negative_reinterpreted": [-2**31, -2**31 + 7, -1_000_000, -1] +
                              [200 + i for i in range(300)],
    "negative_small": [i for i in range(-300, 700) if i],
    "kept_empty": [-5 - i for i in range(40)],
    "negative_variance": [1078549099, 1078549099, 1078549101],
    "negative_variance_wide": [2090470965, 2090470966, 2090470966,
                               2090470967, 2090470967],
    # the reference's int64 guard, len * max^2 against 2^62: (2^31 - 1)^2
    # is just under, two such just over
    "guard_under": [TOP],
    "guard_over": [TOP - 1, TOP],
    "guard_under_many": [2**30 - 1] * 4,
    "guard_over_many": [2**30 - 3, 2**30 - 2, 2**30 - 1, 2**30],
    # 10^5 sizes near 2^31, no spike: every one kept, far past the guard
    "wide_draw": list(TOP - np.random.default_rng(6).integers(
        0, 50_000, 100_000)),
}
for _seed in (2020, 2**31 + 77):
    for _out in (False, True):
        CASES[f"draw_{_seed}_{'outliers' if _out else 'plain'}"] = \
            _draw(_seed, _out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_array_model_equals_jax(name):
    sizes = np.asarray(CASES[name], dtype=np.int64)
    want = jpairing.max_allowed_insert_size_from_sizes(
        sorted(int(x) for x in sizes))
    assert pairing.max_allowed_insert_size_from_sizes(sizes) == want
    # a list, as the host-object path passes, in another order
    assert pairing.max_allowed_insert_size_from_sizes(
        [int(x) for x in sizes[::-1]]) == want
    assert 0 <= want <= U32 - 1

