"""PyTorch port: the count-table engine (PRHO/PRH/NPO) vs the JAX package.

On the CPU the wrappers run their plain twins.  The JAX Pallas kernels run
in interpret mode at the smallest geometry only (chunk_rows=8); larger
cases are held to the JAX XLA twin ``build_tables`` and to the port's
``native.ref_join``.  Integer results, so tolerance is zero.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.ops import bitmap_join as JB
from hwbloomradixjoin_tpu.ops import prho_join as JP
from hwbloomradixjoin_tpu.ops import radix as JR
from hwbloomradixjoin_tpu_torch.data import native
from hwbloomradixjoin_tpu_torch.ops import prho_join as TP
from hwbloomradixjoin_tpu_torch.ops import radix as TR
from port_cpu import lean_cpu  # noqa: F401  (autouse)

PAD = -2**31
M32 = 2**32


def _keys(rng, n, lo, hi):
    """Keys in [lo, hi], above hi, below lo, and PAD."""
    k = rng.integers(lo, hi + 1, n).astype(np.int64)
    u = rng.random(n)
    k[u < 0.2] = rng.integers(hi + 1, hi + 4 * (hi - lo + 1),
                              int((u < 0.2).sum()))
    k[u < 0.1] = rng.integers(-2**31 + 1, lo, int((u < 0.1).sum()))
    k[u > 0.93] = PAD
    return k.astype(np.int32)


def _pays(rng, n):
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def _ref(rk, rp, sk, sp):
    c, r, s = native.ref_join(rk, rp, sk, sp)
    return c, r % M32, s % M32


@pytest.mark.parametrize("bits", [4, 5, 6])
def test_partition_kv_matches_jax_interpret(bits):
    """Keys, payloads and starts equal the JAX Pallas partition_pass_kv."""
    rng = np.random.default_rng(bits)
    lo, hi = 1, 5000                        # range_bits 13: 0..6 bits valid
    pb, shift, _ = TP.plan_geometry_counts(lo, hi, bits)
    assert pb == bits
    keys, pays = _keys(rng, 2 * 8 * 128, lo, hi), _pays(rng, 2 * 8 * 128)
    kw = dict(chunk_rows=8, part_bits=pb, lo=lo, hi=hi, shift=shift)
    want = JR.partition_pass_kv(jnp.asarray(keys), jnp.asarray(pays),
                                interpret=True, geom=JR.RadixGeom(**kw))
    got = TR.partition_pass_kv(torch.from_numpy(keys), torch.from_numpy(pays),
                               TR.RadixGeom(**kw))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_partition_kv_moves_payloads_with_keys():
    """The kv pass's keys and starts are partition_pass's, and every
    (key, payload) pair of a chunk survives the permutation."""
    rng = np.random.default_rng(1)
    lo, hi = 1, 128_000_000
    pb, shift, _ = TP.plan_geometry_counts(lo, hi)
    geom = TR.RadixGeom(chunk_rows=64, part_bits=pb, lo=lo, hi=hi,
                        shift=shift)
    keys = torch.from_numpy(_keys(rng, 3 * 64 * 128, lo, hi))
    pays = torch.arange(keys.numel(), dtype=torch.int32)
    k2, p2, st = TR.partition_pass_kv(keys, pays, geom)
    k1, st1 = TR.partition_pass(keys, geom)
    assert torch.equal(k2, k1) and torch.equal(st, st1)
    assert torch.equal(keys[p2.reshape(-1).long()], k2.reshape(-1))
    chunk = 64 * 128
    assert torch.equal(p2.reshape(3, chunk).sort(dim=1).values,
                       pays.reshape(3, chunk))
    with pytest.raises(ValueError):
        TR.partition_pass_kv(keys, pays[:-1], geom)


@pytest.mark.parametrize("lo,hi,bits", [
    (1, 299, None), (1, 5000, 4), (1000, 200_999, None), (1, 1 << 20, 3),
    (-(1 << 20), (1 << 20) - 1, None), (1, 16_000_000, None),
    (1, 128_000_000, None), (1, 1 << 28, None), (5, 5, None)])
def test_plan_geometry_counts_matches_jax(lo, hi, bits):
    assert TP.plan_geometry_counts(lo, hi, bits) == \
        JP.plan_geometry_counts(lo, hi, bits)


@pytest.mark.parametrize("lo,hi,bits", [(1, 4000, None), (1, 4000, 3),
                                        (-3000, 70_000, None),
                                        (1, 1 << 20, 6)])
def test_build_tables_matches_jax_xla(lo, hi, bits):
    """Non-unique R with out-of-range keys and PAD: the twin's tables equal
    the JAX package's XLA build_tables, and the kernel wrapper's on CPU."""
    rng = np.random.default_rng(hi % 1000)
    rk = np.concatenate([_keys(rng, 20_000, lo, hi),
                         np.full(300, hi, np.int32)])      # 300 in one slot
    rp = _pays(rng, len(rk))
    pb, shift, slr = TP.plan_geometry_counts(lo, hi, bits)
    want = jax.jit(lambda k, p: JP.build_tables(k, p, lo, hi, pb, shift,
                                                slr))(jnp.asarray(rk),
                                                      jnp.asarray(rp))
    got = TP.table_build(torch.from_numpy(rk), torch.from_numpy(rp), lo, hi,
                         pb, shift, slr)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0].max()) >= 300


def test_kernel_wrappers_reject_a_geometry_that_misses_the_tables():
    """A key range past F buckets, or buckets wider than their slices, would
    send the CUDA atomics out of bounds: the wrappers raise first."""
    keys = torch.arange(1, 1025, dtype=torch.int32)
    pb, shift, slr = TP.plan_geometry_counts(1, 1024)
    with pytest.raises(ValueError, match="buckets"):
        TP.table_build(keys, keys, 1, 1 << 20, pb, shift, slr)
    with pytest.raises(ValueError, match="slice"):
        TP.table_build(keys, keys, 1, 1024, pb, shift + 4, slr)
    with pytest.raises(ValueError, match="slice"):
        TP.probe_count_sums(keys, keys, keys, None, 1, shift + 4, pb, slr)


@functools.lru_cache(maxsize=None)
def _jax_probe_inputs():
    """A tiny count geometry: R, S, the JAX XLA tables, S partitioned by the
    JAX Pallas partition_pass_kv (interpret mode) and its descriptors from
    derive_descs; made once per worker for both probe cases."""
    rng = np.random.default_rng(11)
    lo, hi = 1, 1000
    pb, shift, slr = JP.plan_geometry_counts(lo, hi, 2)
    rk = rng.integers(lo, hi + 1, 3000).astype(np.int32)
    rp = _pays(rng, 3000)
    ct, pt = JP.build_tables(jnp.asarray(rk), jnp.asarray(rp), lo, hi, pb,
                             shift, slr)
    nchunks = 3
    sk = _keys(rng, nchunks * 8 * 128, lo, hi)
    sp = _pays(rng, len(sk))
    jgeom = JR.RadixGeom(chunk_rows=8, part_bits=pb, lo=lo, hi=hi,
                         shift=shift)
    s2, p2, st = JR.partition_pass_kv(jnp.asarray(sk), jnp.asarray(sp),
                                      interpret=True, geom=jgeom)
    runs = np.asarray(st).reshape(nchunks, -1)[:, :(1 << pb) + 1]
    geom = JB._probe_geom(pb, shift, slr, lo, 8, nchunks,
                          int(np.diff(runs.astype(np.int64), axis=1).max()))
    rd, od = JB.derive_descs(st.reshape(nchunks, -1, 128), geom)
    return (rk, rp, sk, sp), (ct, pt, s2, p2, st, rd, od, geom), (lo, pb,
                                                                  shift, slr)


@pytest.mark.parametrize("with_spay", [True, False])
def test_probe_matches_jax_pallas_interpret(with_spay):
    """The probe twin equals the JAX Pallas probe_count_sums (interpret mode,
    descriptors from derive_descs) on S partitioned by partition_pass_kv,
    the wrapper given the partition's starts as on the card."""
    (rk, rp, sk, sp), (ct, pt, s2, p2, st, rd, od, geom), \
        (lo, pb, shift, slr) = _jax_probe_inputs()
    want = JP.probe_count_sums(ct, pt, s2, p2 if with_spay else None, rd, od,
                               geom, interpret=True)
    got = TP.probe_count_sums(
        torch.from_numpy(np.array(ct)), torch.from_numpy(np.array(pt)),
        torch.from_numpy(np.array(s2)),
        torch.from_numpy(np.array(p2)) if with_spay else None,
        lo, shift, pb, slr, torch.from_numpy(np.array(st)))
    assert got.tolist() == [int(want[0]), int(want[1]) % M32,
                            int(want[2]) % M32]
    c, r, s = _ref(rk, rp, sk, sp)
    assert got.tolist() == [c, r, s if with_spay else 0]


@pytest.mark.parametrize("case", range(4))
def test_plan_prho_join_full_sums_match_ref_join(case):
    rng = np.random.default_rng(20 + case)
    lo, hi, n_r, n_s, bits = [(1, 4000, 6000, 30_000, None),
                              (1, 300, 900, 5000, None),
                              (-5000, 5000, 30_000, 60_000, 5),
                              (1, 1 << 20, 50_000, 200_000, None)][case]
    rk = rng.integers(lo, hi + 1, n_r).astype(np.int32)
    rp, sk = _pays(rng, n_r), _keys(rng, n_s, lo, hi)
    sp = _pays(rng, n_s)
    plan = TP.plan_prho_join(rk, rp, sk, sp, lo, hi, device="cpu",
                             num_radix_bits=bits)
    assert plan.full_sums() == _ref(rk, rp, sk, sp)
    out = plan.full()
    assert out.dtype == torch.int64 and out.shape == (3,)
    assert list(plan.phase_fns()) == ["r_partition", "build", "s_partition",
                                      "probe"]
    assert torch.equal(plan.phase_fns()["probe"](), out)


def test_plan_prh_join_keys_only():
    rng = np.random.default_rng(5)
    rk = rng.integers(1, 4000, 6000).astype(np.int32)
    rp, sk = _pays(rng, 6000), _keys(rng, 30_000, 1, 3999)
    sp = np.arange(30_000, dtype=np.int32)
    plan = TP.plan_prh_join(rk, rp, sk, 1, 3999, device="cpu")
    assert plan.sp_in is None and plan.s_partition()[1] is None
    c, r, _ = _ref(rk, rp, sk, sp)
    assert plan.full_sums() == (c, r, 0)


def test_multiplicity_guard_declines_like_jax():
    """70,000 copies of one key: both packages' planners return None."""
    rk = np.concatenate([np.full(70000, 5, np.int32),
                         np.arange(1, 1000, dtype=np.int32)])
    rp = np.ones_like(rk)
    assert TP.plan_prho_join(rk, rp, rk[:128], rp[:128], 1, 1000,
                             device="cpu") is None
    assert TP.plan_prh_join(rk, rp, rk[:128], 1, 1000, device="cpu") is None
    keep = np.concatenate([np.full(64998, 5, np.int32),    # 64,999 of key 5
                           np.arange(1, 1000, dtype=np.int32)])
    plan = TP.plan_prho_join(keep, np.ones_like(keep), keep[:128],
                             np.ones(128, np.int32), 1, 1000, device="cpu")
    assert plan is not None


def test_fourteen_bit_count_geometry_joins_in_one_pass():
    """Key spans in (2^27, 2^28] plan 14 count-partition bits, as in the JAX
    package; the port, which once raised there, now joins them in one
    pass: the sums equal ref_join's."""
    rng = np.random.default_rng(27)
    lo, hi = 1, (1 << 27) + 5
    assert TP.plan_geometry_counts(lo, hi)[0] == 14
    rk = np.concatenate([[lo, hi], rng.integers(lo, hi + 1, 3000)]) \
        .astype(np.int32)
    rp = _pays(rng, len(rk))
    sk = np.concatenate([rng.choice(rk, 2000), _keys(rng, 3000, lo, hi)])
    sp = _pays(rng, len(sk))
    plan = TP.plan_prho_join(rk, rp, sk, sp, lo, hi, device="cpu",
                             chunk_rows=8)
    assert plan.geom.part_bits == 14
    assert plan.full_sums() == _ref(rk, rp, sk, sp)


@pytest.mark.parametrize("lo,hi,bits", [(1, 4000, None), (-3000, 70_000, 6)])
def test_table_build_with_starts_matches_jax(lo, hi, bits):
    """table_build given the R partition's starts (the card needs them; the
    CPU twin ignores them) equals build_tables and the JAX package's XLA
    build_tables; starts of the wrong size are refused."""
    rng = np.random.default_rng(hi % 977)
    rk = np.concatenate([_keys(rng, 5000, lo, hi), np.full(200, hi, np.int32)])
    rp = _pays(rng, len(rk))
    pb, shift, slr = TP.plan_geometry_counts(lo, hi, bits)
    geom = TR.RadixGeom(chunk_rows=8, part_bits=pb, lo=lo, hi=hi, shift=shift)
    r_part = TR.partition_pass_kv(TR._chunk_pad(rk, 1024, "cpu"),
                                  TR._chunk_pad(rp, 1024, "cpu"), geom)
    got = TP.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr,
                         r_part[2])
    twin = TP.build_tables(r_part[0], r_part[1], lo, hi, pb, shift, slr)
    want = jax.jit(lambda k, p: JP.build_tables(k, p, lo, hi, pb, shift,
                                                slr))(jnp.asarray(rk),
                                                      jnp.asarray(rp))
    for g, t, w in zip(got, twin, want):
        assert torch.equal(g, t)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="starts"):
        TP.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr,
                       r_part[2][:-8])


def test_entry_points_default_to_the_card():
    """Without device=..., the entry points put their tensors on CUDA: on a
    machine without a card they raise instead of running on the CPU."""
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as TB
    from hwbloomradixjoin_tpu_torch.types import Relation

    keys = np.arange(1, 200, dtype=np.int32)
    calls = [lambda: Relation.from_numpy(keys, keys),
             lambda: TR._chunk_pad(keys, 1024),
             lambda: TR._chunk_pad(torch.from_numpy(keys), 1024),
             lambda: TB.plan_radix_join(keys, keys, 1, 199, chunk_rows=8),
             lambda: TP.plan_prho_join(keys, keys, keys, keys, 1, 199,
                                       chunk_rows=8),
             lambda: TP.plan_prh_join(keys, keys, keys, 1, 199,
                                      chunk_rows=8)]
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def _range_walk(cnt, pay, s_part, sp_part, starts, lo, shift, part_bits,
                slice_rows, nb):
    """What the card's probe and materialize compute, in plain torch: each
    range of nb buckets reads only its merged run [starts[c][b0],
    starts[c][b1]) of every chunk and looks up only the keys whose
    arithmetic bucket lies in [b0, b1); the pad runs [starts[c][F], end)
    are never read and materialize as PAD.  Returns ((count, r_sum, s_sum),
    (out_r, out_s, out_k, n))."""
    F = 1 << part_bits
    cat_words = TR.RadixGeom(part_bits=part_bits).cat_rows * 128
    nchunks = starts.numel() // cat_words
    st = starts.reshape(nchunks, cat_words).long()
    keys = s_part.reshape(nchunks, -1).long()
    pos = torch.arange(keys.shape[1]).expand(nchunks, -1).contiguous()
    firsts = list(range(0, F, nb))
    bounds = st[:, firsts + [F]].contiguous()
    owner = torch.searchsorted(bounds, pos, right=True) - 1   # its range
    b0 = owner * nb
    norm = (keys - lo + 2**31) % M32 - 2**31               # int32 wrap
    bucket = norm >> shift
    look = (owner < len(firsts)) & (bucket >= b0) \
        & (bucket < torch.clamp(b0 + nb, max=F))
    slot = torch.where(look, bucket * slice_rows * 128
                       + (norm & ((1 << shift) - 1)), 0)
    c = cnt.reshape(-1)[slot].long() * look
    p = (pay.reshape(-1)[slot].long() & (M32 - 1)) * look
    sp = torch.zeros_like(keys) if sp_part is None \
        else sp_part.reshape(nchunks, -1).long()
    sums = [int(c.sum()), int(p.sum()) % M32,
            int(((sp & (M32 - 1)) * c).sum()) % M32]
    hit = c > 0
    images = tuple(torch.where(hit, v, PAD).to(torch.int32)
                   .reshape(s_part.shape)
                   for v in (pay.reshape(-1)[slot].long(), sp, keys))
    return sums, images + (int(hit.sum()),)


@pytest.mark.parametrize("nb", [1, 3])
def test_walking_bucket_runs_equals_the_flat_twins(nb):
    """Skipping the pad category's run is exact: S holds keys below lo,
    above hi inside the last bucket and past it (up to lo + F * 2^shift
    and beyond) and PAD; summing over the bucket runs of partitioned S,
    nb buckets a range as the card's CTAs do, equals the flat twins'
    sums (with and without S payloads) and images, and the pad run's keys
    read only zero slots."""
    rng = np.random.default_rng(40 + nb)
    lo, hi = 1, 5000
    pb, shift, slr = TP.plan_geometry_counts(lo, hi, 3)
    top = lo + ((1 << pb) << shift)                 # past the last bucket
    assert (pb, shift) == (3, 10) and hi < top - 1
    rk = rng.choice(np.arange(lo, hi + 1), 3000,
                    replace=False).astype(np.int32)
    rk[:2] = [lo, hi]
    rp = _pays(rng, len(rk))
    edges = np.array([lo - 1, -7, hi + 1, top - 1, top, top + 5, PAD],
                     np.int32)
    sk = np.concatenate([rng.choice(rk, 1200), _keys(rng, 1500, lo, hi),
                         rng.integers(hi + 1, top, 300).astype(np.int32),
                         np.repeat(edges, 10)])
    sp = _pays(rng, len(sk))
    geom = TR.RadixGeom(chunk_rows=8, part_bits=pb, lo=lo, hi=hi, shift=shift)
    r_part = TR.partition_pass_kv(TR._chunk_pad(rk, 1024, "cpu"),
                                  TR._chunk_pad(rp, 1024, "cpu"), geom)
    tables = TP.build_tables(r_part[0], r_part[1], lo, hi, pb, shift, slr)
    s_part = TR.partition_pass_kv(TR._chunk_pad(sk, 1024, "cpu"),
                                  TR._chunk_pad(sp, 1024, "cpu"), geom)
    args = (lo, shift, pb, slr)
    sums, images = _range_walk(*tables, s_part[0], s_part[1], s_part[2],
                               *args, nb)
    flat = TP.probe_count_sums_plain(*tables, *s_part[:2], *args)
    assert sums == flat.tolist() == list(_ref(rk, rp, sk, sp))
    keys_only, _ = _range_walk(*tables, s_part[0], None, s_part[2], *args, nb)
    assert keys_only == TP.probe_count_sums_plain(
        *tables, s_part[0], None, *args).tolist() == sums[:2] + [0]
    want = TP.materialize_pairs_plain(*tables, *s_part[:2], *args)
    for g, w in zip(images[:3], want[:3]):
        assert torch.equal(g, w)
    assert images[3] == int(want[3]) == int(np.isin(sk, rk).sum())
    # the flat test admits pad-run keys in (hi, top): their slots are zero
    k = s_part[0].reshape(-1).long()
    above = (k > hi) & (k < top)
    assert int(above.sum()) >= 300
    assert int(tables[0].reshape(-1)[(k[above] - lo) // (1 << shift) * slr
                                     * 128 + (k[above] - lo) % (1 << shift)]
               .abs().sum()) == 0
    with pytest.raises(ValueError, match="starts"):
        TP.probe_count_sums(*tables, *s_part[:2], *args, s_part[2][:-1])
    with pytest.raises(ValueError, match="starts"):
        TP.materialize_pairs(*tables, *s_part[:2], *args, s_part[2][:-1])
