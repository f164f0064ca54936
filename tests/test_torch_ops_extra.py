"""PyTorch port: the standalone operators and the leftover helpers against
the JAX package.

radix_cluster against the port's own partition twin (no JAX interpret
mode); radix_sort, group_by_key, join_group_count, hash_multiplicative,
csr_hash_join_count and the count-table pair against the JAX package's
functions jitted on the CPU, element for element, on seeded numpy inputs;
the checks of tests/test_ops_extra.py repeated on the port.  Integer
results, so every comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.ops import aggregate as JA
from hwbloomradixjoin_tpu.ops import ht_join as JH
from hwbloomradixjoin_tpu.ops import sort as JS
from hwbloomradixjoin_tpu.ops import xla_join as JX
import hwbloomradixjoin_tpu_torch as port
from hwbloomradixjoin_tpu_torch.ops import aggregate, ht_join, sort, xla_join
from hwbloomradixjoin_tpu_torch.ops import radix as TR
from port_cpu import lean_cpu  # noqa: F401  (autouse)

PAD = -2**31


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("lo,hi,bits,n", [(0, (1 << 16) - 1, 4, 40000),
                                          (-5000, 5000, 3, 70000)])
def test_radix_cluster_is_the_partition_pass(lo, hi, bits, n):
    """radix_cluster equals the partition twin at shift = range_bits -
    bits, chunk for chunk; each bucket run holds its bucket's keys, keys
    outside [lo, hi] go to the tail (test_ops_extra.py:76's checks)."""
    rng = np.random.default_rng(11)
    keys = rng.integers(lo - 300, hi + 300, n).astype(np.int32)
    out, starts = sort.radix_cluster(keys, lo, hi, bits, chunk_rows=256,
                                     device="cpu")
    range_bits = max((hi - lo).bit_length(), bits)
    geom = TR.RadixGeom(chunk_rows=256, part_bits=bits, lo=lo, hi=hi,
                        shift=range_bits - bits)
    want_out, want_starts = TR.partition_pass_plain(
        TR._chunk_pad(keys, 256 * 128, "cpu"), geom)
    assert torch.equal(out, want_out)
    assert torch.equal(starts.reshape(-1, 128), want_starts)
    assert starts.shape == (-(-n // (256 * 128)), geom.cat_rows, 128)
    flat, st = out.reshape(starts.shape[0], -1).numpy(), \
        starts.reshape(starts.shape[0], -1).numpy()
    inside = []
    for c in range(starts.shape[0]):
        for b in range(1 << bits):
            run = flat[c, st[c, b]:st[c, b + 1]].astype(np.int64)
            assert ((run - lo) >> (range_bits - bits) == b).all()
        inside.append(flat[c, :st[c, 1 << bits]])
    ok = (keys >= lo) & (keys <= hi)
    assert np.array_equal(np.sort(np.concatenate(inside)), np.sort(keys[ok]))


@pytest.mark.parametrize("descending", [False, True])
def test_radix_sort_matches_jax(descending):
    """Stable either way: keys over all of int32 with many ties, payloads
    following; equal to JAX's radix_sort and to numpy's stable order
    (test_ops_extra.py:42)."""
    rng = np.random.default_rng(13)
    keys = rng.integers(-2**31, 2**31, 5000).astype(np.int32)
    keys[::3] = keys[1::3][:len(keys[::3])]
    keys[7] = PAD
    pays = np.arange(5000, dtype=np.int32)
    ks, ps = sort.radix_sort(_t(keys), _t(pays), descending=descending)
    jks, jps = jax.jit(lambda k, p: JS.radix_sort(
        k, p, descending=descending))(keys, pays)
    assert np.array_equal(ks.numpy(), np.asarray(jks))
    assert np.array_equal(ps.numpy(), np.asarray(jps))
    order = np.argsort(~keys if descending else keys, kind="stable")
    assert np.array_equal(ks.numpy(), keys[order])
    assert np.array_equal(ps.numpy(), pays[order])
    assert torch.equal(sort.radix_sort(_t(keys)), _t(np.sort(keys)))


def _groups(seed, n, span, values):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-span, span, n).astype(np.int32)
    keys[::11] = PAD
    if values == "none":
        return keys, None
    if values == "negative":
        return keys, rng.integers(-1000, 1000, n).astype(np.int32)
    # sums past 2^32 in one group: uint32 wraparound
    return keys, rng.integers(2**30, 2**31, n).astype(np.int32)


@pytest.mark.parametrize("values", ["none", "negative", "wrap"])
def test_group_by_key_matches_jax(values):
    """The four outputs equal JAX's group_by_key element for element (the
    PAD/0 tail included), and the groups equal numpy's
    (test_ops_extra.py:8)."""
    keys, vals = _groups(17, 3000, 60, values)
    got = aggregate.group_by_key(_t(keys), None if vals is None else
                                 _t(vals))
    want = jax.jit(JA.group_by_key)(keys, vals)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(_np(g), _np(w) & 0xFFFFFFFF if
                              w.dtype == jnp.uint32 else _np(w))
    ng = int(got[3])
    assert ng == int(want[3])
    assert got[1].dtype == torch.int32 and got[3].dtype == torch.int32
    uk, counts = np.unique(keys, return_counts=True)
    assert ng == len(uk)
    assert np.array_equal(got[0][:ng].numpy(), uk)
    assert np.array_equal(got[1][:ng].numpy(), counts)
    v = np.zeros(len(keys), np.int64) if vals is None else \
        vals.astype(np.uint32).astype(np.int64)
    sums = np.array([v[keys == k].sum() % 2**32 for k in uk])
    assert np.array_equal(got[2][:ng].numpy(), sums)
    if values == "wrap":
        assert (np.array([v[keys == k].sum() for k in uk]) >= 2**32).any()
    assert (got[0][ng:] == PAD).all() and not got[1][ng:].any()


@pytest.mark.parametrize("seed", [12, 19])
def test_join_group_count_matches_jax(seed):
    """Keys, group counts and the group count equal JAX's join_group_count
    element for element; the groups are r_mult * s_mult of numpy's
    intersection and total the join's count (test_ops_extra.py:24)."""
    rng = np.random.default_rng(seed)
    rk = rng.integers(0, 30, 200).astype(np.int32)
    sk = rng.integers(0, 40, 1000).astype(np.int32)
    sk[::13] = PAD
    keys, counts, ng = aggregate.join_group_count(_t(rk), _t(sk))
    jk, jc, jng = jax.jit(JA.join_group_count)(rk, sk)
    assert np.array_equal(keys.numpy(), np.asarray(jk))
    assert np.array_equal(counts.numpy(), np.asarray(jc))
    assert int(ng) == int(jng) and keys.shape == (200,)
    want = {int(k): int((rk == k).sum() * (sk == k).sum())
            for k in np.intersect1d(rk, sk)}
    ng = int(ng)
    assert dict(zip(keys[:ng].tolist(), counts[:ng].tolist())) == want
    assert int(counts.sum()) == sum(want.values()) == \
        int(xla_join.sort_scan_count(_t(rk), _t(rk), _t(sk), _t(sk))[0])


def test_hash_multiplicative_matches_jax():
    """Every width from 1 to 31 bits over keys either side of the sign
    bit: the logical shift of the uint32 product, as JAX's."""
    rng = np.random.default_rng(5)
    keys = rng.integers(-2**31, 2**31, 4000).astype(np.int32)
    keys[:3] = (PAD, -1, 2**31 - 1)
    for bits in range(1, 32):
        got = xla_join.hash_multiplicative(_t(keys), bits)
        want = np.asarray(JX.hash_multiplicative(jnp.asarray(keys), bits))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), bits


@pytest.mark.parametrize("case", ["unique", "duplicates", "overflow"])
def test_csr_hash_join_count_matches_jax(case):
    """(count, both checksums, overflow) equal JAX's csr_hash_join_count;
    within its window the count is the join's; a bucket past max_bucket
    sets overflow on both sides."""
    rng = np.random.default_rng(23)
    nr, ns = 3000, 20000
    rk = rng.permutation(np.arange(1, nr + 1)).astype(np.int32)
    if case != "unique":
        rk[::4] = rk[1::4][:len(rk[::4])]
    if case == "overflow":
        rk[:40] = 77
    rp = rng.integers(-2**31, 2**31, nr).astype(np.int32)
    sk = rng.integers(1, 2 * nr, ns).astype(np.int32)
    sp = rng.integers(-2**31, 2**31, ns).astype(np.int32)
    got = xla_join.csr_hash_join_count(_t(rk), _t(rp), _t(sk), _t(sp))
    want = jax.jit(JX.csr_hash_join_count)(rk, rp, sk, sp)
    assert [int(v) for v in got] == [int(want[0]), int(want[1]),
                                     int(want[2]), int(want[3])]
    assert bool(got[3]) == (case == "overflow")
    if case != "overflow":
        exact = xla_join.sort_scan_count(_t(rk), _t(rp), _t(sk), _t(sp))
        assert [int(v) for v in got[:3]] == [int(v) for v in exact]


@pytest.mark.parametrize("checksums", [True, False])
def test_counttable_pair_matches_jax(checksums):
    """counttable_join_count and counttable_probe_mask equal JAX's over a
    repeated R with keys outside [lo, hi] and PAD on both sides."""
    rng = np.random.default_rng(31)
    lo, hi = 100, 2100
    rk = rng.integers(lo - 50, hi + 50, 3000).astype(np.int32)
    rk[::17] = PAD
    rp = rng.integers(-2**31, 2**31, 3000).astype(np.int32)
    sk = rng.integers(lo - 200, hi + 200, 9000).astype(np.int32)
    sk[::13] = PAD
    sp = rng.integers(-2**31, 2**31, 9000).astype(np.int32)
    got = ht_join.counttable_join_count(_t(rk), _t(rp), _t(sk), _t(sp), lo,
                                        hi, with_checksums=checksums)
    want = jax.jit(JH.counttable_join_count, static_argnums=(4, 5, 6))(
        rk, rp, sk, sp, lo, hi, checksums)
    assert [int(v) for v in got] == [int(w) for w in want]
    mask = ht_join.counttable_probe_mask(_t(rk), _t(sk), lo, hi)
    jmask = jax.jit(JH.counttable_probe_mask, static_argnums=(2, 3))(
        rk, sk, lo, hi)
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    inside = rk[(rk >= lo) & (rk <= hi)]
    assert np.array_equal(mask.numpy(), np.isin(sk, inside))


def test_package_surface_and_phase_timer():
    """The package exports the JAX package's names (BloomArgs,
    BloomVariant, key_dtype); key_dtype gives torch's int64 or int32."""
    import hwbloomradixjoin_tpu as jpkg
    assert set(jpkg.__all__) <= set(port.__all__)
    assert port.key_dtype(True) is torch.int64
    assert port.key_dtype() is torch.int32
    assert port.BloomArgs().variant is port.BloomVariant.BASIC
