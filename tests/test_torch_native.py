"""PyTorch port: its copy of the native binding vs the JAX package's.

Both load the same C++ source (``native/hbrj_native.cpp``); the port builds
its own copy into its git-ignored build directory and must return exactly
the JAX package's arrays and sums.
"""

import os

import numpy as np
import pytest

from hwbloomradixjoin_tpu.data import native as JN
from hwbloomradixjoin_tpu_torch.data import native as TN
from port_cpu import lean_cpu  # noqa: F401  (autouse)


@pytest.mark.parametrize("seed,n,minid,maxid", [(12345, 1000, 0, 37),
                                                (7, 50_000, 0, 2**31 - 1),
                                                (54321, 333, 100, 101)])
def test_random_gen_matches_jax(seed, n, minid, maxid):
    got = TN.random_gen(seed, n, minid, maxid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, JN.random_gen(seed, n, minid, maxid))


@pytest.mark.parametrize("threshold,q", [(500, 1.0), (500, 0.3), (77, 0.01)])
def test_fk_generators_match_jax(threshold, q):
    pk = TN.random_gen(3, 800, 0, threshold)
    pays = np.arange(800, dtype=np.int32)
    np.testing.assert_array_equal(
        TN.nonunique_from_pk(9, pk, 5000, threshold, q),
        JN.nonunique_from_pk(9, pk, 5000, threshold, q))
    for got, want in zip(TN.fk_from_pk(9, pk, pays, 5000, threshold, q),
                         JN.fk_from_pk(9, pk, pays, 5000, threshold, q)):
        np.testing.assert_array_equal(got, want)


def test_ref_join_matches_jax():
    rng = np.random.default_rng(4)
    rk = rng.integers(1, 3000, 9000).astype(np.int32)
    sk = rng.integers(-10, 4000, 40_000).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, 9000, dtype=np.int64).astype(np.int32)
    sp = rng.integers(-2**31, 2**31, 40_000, dtype=np.int64).astype(np.int32)
    got = TN.ref_join(rk, rp, sk, sp)
    assert got == JN.ref_join(rk, rp, sk, sp)
    keys, mult = np.unique(rk, return_counts=True)
    pos = np.searchsorted(keys, sk).clip(0, len(keys) - 1)
    assert got[0] == int(np.where(keys[pos] == sk, mult[pos], 0).sum())


def test_builds_into_the_package_build_dir():
    """The library lands in the git-ignored build/ under a hashed name;
    native/ is left as it was."""
    tracked = os.path.join(os.path.dirname(TN.SOURCE), "libhbrj_native.so")
    before = os.path.getmtime(tracked)
    so = TN.build()
    assert so.parent == TN.BUILD_DIR and so.exists()
    assert so.name.startswith("libhbrj_native_") and len(so.stem) > 20
    assert TN.build() == so
    assert os.path.getmtime(tracked) == before
