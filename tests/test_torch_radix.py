"""PyTorch port: radix partition and compaction against the JAX package.

On the CPU the wrappers run their plain twins; the JAX kernels run in
interpret mode at tiny chunks (chunk_rows=8/16), and larger sizes are checked
against numpy's stable sort.  Integer layouts, so tolerance is zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.ops import radix as JR
from hwbloomradixjoin_tpu_torch.ops import radix as TR
from port_cpu import lean_cpu  # noqa: F401  (autouse)

PAD = -2**31


def _keys(rng, n, lo, hi, pad_frac=0.1, out_frac=0.2):
    """Keys in [lo, hi] plus PAD and out-of-range keys on both sides."""
    k = rng.integers(lo, hi + 1, n).astype(np.int64)
    u = rng.random(n)
    k[u < out_frac] = rng.integers(hi + 1, hi + 5 * (hi - lo + 1),
                                   int((u < out_frac).sum()))
    k[u < out_frac / 2] = rng.integers(-2**31 + 1, lo,
                                       int((u < out_frac / 2).sum()))
    k[u > 1 - pad_frac] = PAD
    return k.astype(np.int32)


@pytest.mark.parametrize("pad_cat", [True, False])
def test_partition_matches_jax_interpret(pad_cat):
    rng = np.random.default_rng(3 + pad_cat)
    lo, hi = 100, 5099                      # range_bits 13
    keys = _keys(rng, 2 * 8 * 128, lo, hi)
    kw = dict(chunk_rows=8, part_bits=3, lo=lo, hi=hi, shift=10,
              pad_cat=pad_cat)
    want_k, want_s = JR.partition_pass(jnp.asarray(keys), interpret=True,
                                       geom=JR.RadixGeom(**kw))
    got_k, got_s = TR.partition_pass(torch.from_numpy(keys),
                                     TR.RadixGeom(**kw))
    assert got_k.shape == want_k.shape and got_s.shape == want_s.shape
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_compact_matches_jax_interpret_with_truncation():
    rng = np.random.default_rng(5)
    lo, hi = 1000, 400_000
    keys = _keys(rng, 2 * 16 * 128, lo, hi, pad_frac=0.05, out_frac=0.3)
    keys[:100] = PAD                        # chunk 0: fewer live keys
    want_k, want_c = JR.compact_pass(jnp.asarray(keys), lo, hi, 16,
                                     cap_rows=8, interpret=True)
    got_k, got_c = TR.compact_pass(torch.from_numpy(keys), lo, hi, 16,
                                   cap_rows=8)
    live = ((keys >= lo) & (keys <= hi)).reshape(2, -1).sum(1)
    assert (live > 8 * 128).all()           # the cap really truncates
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def _stable_reference(keys, geom):
    cat = TR.geom_cat_fn(geom)(torch.from_numpy(keys)).numpy()
    chunk = geom.chunk_rows * 128
    out, starts = [], []
    for c in range(len(keys) // chunk):
        cc = cat[c * chunk:(c + 1) * chunk]
        order = np.argsort(cc, kind="stable")
        out.append(keys[c * chunk:(c + 1) * chunk][order])
        starts.append(np.searchsorted(np.sort(cc),
                                      np.arange(geom.cat_rows * 128)))
    return np.concatenate(out), np.concatenate(starts)


@pytest.mark.parametrize("part_bits,shift,lo,hi,pad_cat,chunk_rows", [
    (0, 12, 1, 3000, True, 40),
    (6, 18, 1, 16_000_000, True, 64),
    (6, 18, 1, 16_000_000, False, 64),
    (9, 18, 1, 128_000_000, True, 32),
    (13, 12, -(1 << 24), (1 << 24) - 1, True, 96),
    (5, 19, 0, (1 << 24) - 1, None, 64),      # hi None: no range prune
])
def test_partition_stable_and_starts(part_bits, shift, lo, hi, pad_cat,
                                     chunk_rows):
    rng = np.random.default_rng(part_bits + chunk_rows)
    keys = _keys(rng, 3 * chunk_rows * 128, lo, hi)
    geom = TR.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits, lo=lo,
                        hi=None if pad_cat is None else hi, shift=shift,
                        pad_cat=pad_cat is not False)
    got_k, got_s = TR.partition_pass(torch.from_numpy(keys), geom)
    want_k, want_s = _stable_reference(keys, geom)
    np.testing.assert_array_equal(got_k.numpy().ravel(), want_k)
    np.testing.assert_array_equal(got_s.numpy().ravel(), want_s)
    # starts are suffix-filled: the chunk size past the last category
    s = got_s.numpy().reshape(3, -1)
    assert (s[:, geom.ncats:] == chunk_rows * 128).all()
    assert (np.diff(s, axis=1) >= 0).all()


def test_cat_fn_matches_jax():
    rng = np.random.default_rng(9)
    keys = np.concatenate([
        _keys(rng, 4096, 7, 1 << 20),
        np.array([PAD, 2**31 - 1, -2**31 + 1, 6, 7, 1 << 20, (1 << 20) + 1],
                 np.int32)])
    for pad_cat in (True, False):
        for hi in (1 << 20, None):
            kw = dict(chunk_rows=8, part_bits=4, lo=7, hi=hi, shift=17,
                      pad_cat=pad_cat)
            want = JR.geom_cat_fn(JR.RadixGeom(**kw))(jnp.asarray(keys))
            got = TR.geom_cat_fn(TR.RadixGeom(**kw))(torch.from_numpy(keys))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("lo,hi", [(1, 16_000_000), (0, 2**31 - 1),
                                   ((1 << 31) - (1 << 20), 2**31 - 1),
                                   (-5, 100), (1, 1)])
def test_pad_cat_safe_and_cat_rows_match_jax(lo, hi):
    assert TR.pad_cat_safe(lo, hi) == JR.pad_cat_safe(lo, hi)
    for bits in (0, 6, 7, 9, 13):
        assert TR.RadixGeom(part_bits=bits).cat_rows == \
            JR.RadixGeom(part_bits=bits).cat_rows


def test_compact_no_cap_and_chunk_pad():
    rng = np.random.default_rng(6)
    keys = _keys(rng, 1000, 1, 5000)
    padded = TR._chunk_pad(keys, 8 * 128, "cpu")
    assert padded.shape == (1024,) and (padded[1000:] == PAD).all()
    assert torch.equal(TR._chunk_pad(torch.from_numpy(keys), 8 * 128, "cpu"),
                       padded)
    out, counts = TR.compact_pass(padded, 1, 5000, 8)
    live = keys[(keys >= 1) & (keys <= 5000)]
    np.testing.assert_array_equal(out.numpy().ravel()[:len(live)], live)
    assert (out.numpy().ravel()[len(live):] == PAD).all()
    assert (counts.numpy() == len(live)).all()


def test_partition_takes_wide_fanout_and_rejects_bad_shapes():
    """Fan-outs past 13 bits, which the port once refused, now partition
    in one pass: 14 and 17 bits, keys only and with payloads, equal the
    JAX Pallas passes (interpret mode) at chunk_rows=8.  Bad shapes and a
    hash geometry wider than its block bits are still refused."""
    rng = np.random.default_rng(14)
    lo, hi = 1, (1 << 21) - 3
    for part_bits in (14, 17):
        keys = _keys(rng, 2 * 8 * 128, lo, hi)
        pays = rng.integers(-2**31, 2**31, len(keys),
                            dtype=np.int64).astype(np.int32)
        kw = dict(chunk_rows=8, part_bits=part_bits, lo=lo, hi=hi,
                  shift=21 - part_bits)
        want = JR.partition_pass_kv(jnp.asarray(keys), jnp.asarray(pays),
                                    interpret=True, geom=JR.RadixGeom(**kw))
        got = TR.partition_pass_kv(torch.from_numpy(keys),
                                   torch.from_numpy(pays), TR.RadixGeom(**kw))
        got_k, got_s = TR.partition_pass(torch.from_numpy(keys),
                                         TR.RadixGeom(**kw))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(got_k, got[0]) and torch.equal(got_s, got[2])
    keys = torch.zeros(8 * 128, dtype=torch.int32)
    with pytest.raises(ValueError):
        TR.partition_pass(keys[:-1], TR.RadixGeom(chunk_rows=8, part_bits=2))
    with pytest.raises(ValueError):
        TR.compact_pass(keys, 0, 10, 8, cap_rows=12)
    with pytest.raises(ValueError, match="hash mode"):   # 12 of 0 bits
        TR.RadixGeom(hash_seed=3)


# The three inputs of tests/test_radix.py (JAX geometry and R capacity in
# segments, r_segs), the one-bucket case grown past the port's capacity of
# R_CAP keys so that both sides overflow.
_GATHERED_CASES = {
    "unique": (7, dict(chunk_rows=32, part_bits=4, s_segs=8, r_segs=4)),
    "duplicates": (8, dict(chunk_rows=32, part_bits=4, s_segs=8, r_segs=8)),
    "one_bucket": (None, dict(chunk_rows=32, part_bits=4, s_segs=8,
                              r_segs=2)),
}


def _gathered_input(case):
    seed, _ = _GATHERED_CASES[case]
    if case == "one_bucket":           # all R keys in bucket 0
        return (np.arange(TR.R_CAP + 1, dtype=np.int32) * 16,
                np.arange(0, 64000, 16, dtype=np.int32))
    rng = np.random.default_rng(seed)
    if case == "unique":
        return (rng.permutation(np.arange(1, 3001)).astype(np.int32),
                rng.integers(1, 9000, 12000).astype(np.int32))
    return (rng.integers(0, 500, 2000).astype(np.int32),
            rng.integers(0, 700, 8000).astype(np.int32))


@pytest.mark.parametrize("case", list(_GATHERED_CASES))
def test_radix_join_count_matches_jax_interpret(case):
    """radix_join_count (its twins here) against the Pallas
    radix_join_count_pallas in interpret mode, at the JAX test's geometry:
    the same count, exactly, and the same overflow."""
    from hwbloomradixjoin_tpu.data import native

    rk, sk = _gathered_input(case)
    _, kw = _GATHERED_CASES[case]
    jgeom = JR.RadixGeom(**kw)
    want, jovf = JR.radix_join_count_pallas(rk, sk, interpret=True,
                                            geom=jgeom)
    got, ovf = TR.radix_join_count(
        rk, sk, TR.RadixGeom(chunk_rows=kw["chunk_rows"],
                             part_bits=kw["part_bits"]), device="cpu")
    assert ovf == jovf == (case == "one_bucket")
    assert got == int(want)
    if not ovf:
        assert got == native.ref_join(rk, np.zeros_like(rk), sk,
                                       np.zeros_like(sk))[0]


@pytest.mark.parametrize("extra", [0, 1])
def test_gathered_probe_at_and_past_the_capacity(extra):
    """A bucket of exactly R_CAP R keys is probed; one more key overflows,
    and only that bucket's S keys go uncounted in the raw count."""
    geom = TR.RadixGeom(chunk_rows=8, part_bits=3)
    hot = (np.arange(TR.R_CAP + extra, dtype=np.int32) % 20_480) * 8  # bucket 0
    cold = np.arange(1, 2000, dtype=np.int32)
    cold = cold[cold % 8 != 0]
    rk = np.concatenate([hot, cold])
    sk = np.concatenate([hot[:500], cold[::3], np.full(50, PAD, np.int32)])
    parts = []
    for keys in (rk, sk):
        parts += TR.partition_pass(TR._chunk_pad(keys, 1024, "cpu"), geom)
    count, ovf = TR.gathered_probe_count(*parts, geom).tolist()
    n_cold = len(cold[::3])
    assert ovf == extra
    assert count == n_cold + (0 if extra else 500 * 2)
    assert TR.radix_join_count(rk, sk, geom, "cpu") == \
        ((0, True) if extra else (n_cold + 1000, False))


def test_radix_join_count_default_geometry():
    """The default geometry (12 low bits, chunks of 1024 rows, R_CAP
    40,960) over negative keys, repeats and PAD: ref_join's count.  A
    hash-mode geometry is refused."""
    from hwbloomradixjoin_tpu.data import native

    rng = np.random.default_rng(17)
    rk = rng.integers(-50_000, 50_000, 30_000).astype(np.int32)
    sk = rng.integers(-60_000, 60_000, 200_000).astype(np.int32)
    sk[::101] = PAD
    assert TR.RadixGeom() == TR.RadixGeom(chunk_rows=JR.CHUNK_ROWS,
                                          part_bits=JR.PART_BITS)
    assert TR.R_CAP == JR.R_SEGS * JR.SEG_ROWS * 128
    want = native.ref_join(rk, np.zeros_like(rk), sk, np.zeros_like(sk))[0]
    assert TR.radix_join_count(rk, sk, device="cpu") == (want, False)
    with pytest.raises(ValueError, match="range-mode"):
        TR.radix_join_count(rk, sk, TR.RadixGeom(
            hash_seed=3, hash_bits=12), device="cpu")
