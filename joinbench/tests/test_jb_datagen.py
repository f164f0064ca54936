"""The device generator against the port's host generator."""

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu_torch.data import generator as G
from joinbench import datagen, reference

INT_MAX = 2**31 - 1

CASES = [  # n, nthreads, maxid, threshold, selectivity, tuple_bytes
    (3000, 1, 3000, 3000, 1.0, 8),
    (3000, 8, 3000, 3000, 1.0, 8),
    (24000, 3, INT_MAX, 3000, 1.0, 8),
    (24000, 3, INT_MAX, 3000, 0.01, 8),
    (100_000, 48, INT_MAX, 12_345, 0.01, 8),
    (100_000, 7, INT_MAX, 9_000, 0.37, 16),
    (5000, 4, INT_MAX, 5000, 0.5, 8),
    (56, 4, INT_MAX, 15, 1.0, 8),      # a run whose first key is 0
    (40, 4, 12, 10, 0.5, 8),           # an above run starting at threshold
]


@pytest.mark.parametrize("n,nthreads,maxid,threshold,q,tb", CASES)
def test_key_multiset_equals_parallel_create_relation(n, nthreads, maxid,
                                                      threshold, q, tb):
    want, _ = G.parallel_create_relation(n, nthreads, maxid, threshold, q,
                                         tuple_bytes=tb)
    got = datagen.ordered_keys(n, nthreads, maxid, threshold, q, tb)
    np.testing.assert_array_equal(np.sort(got.numpy()), np.sort(want))


def test_count_equals_expected_uniform_match_count(tiny):
    for workload in ("workload_b.pro", "brj_flagship.bloom"):
        _, config, _, _ = tiny(workload)
        rel = datagen.make(config, 2**31 + 11, "cpu")
        got = reference.join(rel.r_key, rel.r_pay, rel.s_key, rel.s_pay)
        assert got["count"] == G.expected_uniform_match_count(
            config["s_size"], config["selectivity"])


def test_relations_follow_the_seed(tiny):
    _, config, _, _ = tiny("brj_flagship.bloom")
    a = datagen.make(config, 2**31 + 5, "cpu")
    b = datagen.make(config, 2**31 + 5, "cpu")
    c = datagen.make(config, 2**31 + 6, "cpu")
    for x, y in ((a.r_key, b.r_key), (a.s_key, b.s_key)):
        assert torch.equal(x, y)
    assert not torch.equal(a.s_key, c.s_key)
    assert torch.equal(a.s_key.sort().values, c.s_key.sort().values)
    assert torch.equal(a.r_key.sort().values,
                       torch.arange(1, config["r_size"] + 1,
                                    dtype=torch.int32))
    assert torch.equal(a.s_pay, torch.arange(config["s_size"],
                                             dtype=torch.int32))
    assert a.column_bytes() == 8 * (config["r_size"] + config["s_size"])


@pytest.mark.card
def test_device_multiset_equals_host(card):
    n, threshold = 1 << 22, 1 << 19
    got = datagen.shuffled(datagen.ordered_keys(
        n, 48, INT_MAX, threshold, 0.01, 8, card),
        datagen.generator(7, card)).cpu()
    want, _ = G.parallel_create_relation(n, 48, INT_MAX, threshold, 0.01)
    np.testing.assert_array_equal(np.sort(got.numpy()), np.sort(want))
