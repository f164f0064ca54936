"""PyTorch port: the ten seeded hashes and the uint32 helpers, exactly.

The torch hashes against the reference binary's golden vectors
(tests/fixtures/hash_golden.npz: per-pair seeds, edge keys, bytes >= 0x80)
and against the JAX package's hashes on random int32 keys; the u32/u64
helpers against Python's integers.
"""

import os

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.ops import hashes as jhashes
from hwbloomradixjoin_tpu_torch.ops import hashes
from hwbloomradixjoin_tpu_torch.ops import u32 as U
from port_cpu import lean_cpu  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "hash_golden.npz")
NAMES = list(hashes.HASH_FUNCTIONS)


@pytest.fixture(scope="module")
def golden():
    return np.load(FIXTURE)


def test_registry_order_matches_jax():
    assert NAMES == list(jhashes.HASH_FUNCTIONS)


@pytest.mark.parametrize("name", NAMES)
def test_hash_matches_reference_goldens(golden, name):
    seeds = torch.from_numpy(golden[name + "_seed"].astype(np.int64))
    keys = torch.from_numpy(golden[name + "_key"])
    got = hashes.HASH_FUNCTIONS[name](seeds, keys)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), golden[name + "_hash"].astype(np.int64))


@pytest.mark.parametrize("name", NAMES)
def test_hash_matches_jax(name):
    """Random int32 keys (negatives, every byte value) and edge keys, one
    scalar seed and one seed a key, against the JAX package's hash."""
    rng = np.random.default_rng(NAMES.index(name))
    keys = np.concatenate([
        rng.integers(-2**31, 2**31, 4000, dtype=np.int64),
        [0, -1, -2**31, 2**31 - 1, 0x80, 0xFF, 0x8080, -0x80]]).astype(np.int32)
    seeds = rng.integers(0, 2**32, len(keys), dtype=np.int64)
    fn, jfn = hashes.HASH_FUNCTIONS[name], jhashes.HASH_FUNCTIONS[name]
    for seed, jseed in ((42, np.uint32(42)),
                        (torch.from_numpy(seeds), seeds.astype(np.uint32))):
        got = fn(seed, torch.from_numpy(keys)).numpy()
        want = np.asarray(jfn(jseed, keys.view(np.uint32))).astype(np.int64)
        assert np.array_equal(got, want), name


def test_crc_table_is_the_bitwise_crc():
    """The byte table gives the 32-step reflected division of the JAX
    package's hash_crc for every single-byte-set key."""
    keys = np.array([b << s for s in (0, 8, 16, 24) for b in range(256)],
                    np.int64).astype(np.uint32)
    got = hashes.hash_crc(0, torch.from_numpy(keys.astype(np.int64)))
    want = np.asarray(jhashes.hash_crc(np.uint32(0), keys))
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_u32_helpers_match_python_integers():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 2**32, 3000, dtype=np.int64)
    b = rng.integers(0, 2**32, 3000, dtype=np.int64)
    a[:4], b[:4] = [0, 2**32 - 1, 2**32 - 1, 1], [0, 2**32 - 1, 1, 2**32 - 1]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    prod = [int(x) * int(y) for x, y in zip(a, b)]
    assert U.mul_lo(ta, tb).tolist() == [p & 0xFFFFFFFF for p in prod]
    assert U.mul_hi(ta, tb).tolist() == [p >> 32 for p in prod]
    for r in (0, 1, 5, 31, 32, 37):
        want = [((int(x) << (r % 32)) | (int(x) >> (32 - r % 32)))
                & 0xFFFFFFFF for x in a]
        assert U.rotl32(ta, r).tolist() == want
    u64 = [(int(x) << 32) | int(y) for x, y in zip(a, b)]
    v64 = [(int(y) << 32) | int(x) for x, y in zip(a, b)]
    hi, lo = U.u64_add(ta, tb, tb, ta)
    assert [(h << 32) | lo_ for h, lo_ in zip(hi.tolist(), lo.tolist())] == \
        [(x + y) % 2**64 for x, y in zip(u64, v64)]
    for r in (0, 9, 32, 52, 63):
        hi, lo = U.u64_rotl(ta, tb, r)
        want = [((x << r) | (x >> (64 - r))) % 2**64 if r else x for x in u64]
        assert [(h << 32) | lo_ for h, lo_ in
                zip(hi.tolist(), lo.tolist())] == want
    byte = torch.arange(256)
    assert U.sign_extend_byte(byte).tolist() == \
        [x if x < 0x80 else x | 0xFFFFFF00 for x in range(256)]
