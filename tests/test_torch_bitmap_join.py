"""PyTorch port: bitmap build/probe and the planned radix join vs the JAX package.

Integer results, compared exactly.  JAX Pallas kernels run in interpret mode
at tiny chunks; larger cases are held to the JAX XLA twin ``build_bitmap``
and to ``native.ref_join``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.data import native
from hwbloomradixjoin_tpu.ops import bitmap_join as JB
from hwbloomradixjoin_tpu.ops import radix as JR
from hwbloomradixjoin_tpu_torch.data import generator as TG
from hwbloomradixjoin_tpu_torch.ops import bitmap_join as TB

PAD = -2**31


def _ref_count(rk, sk):
    return native.ref_join(rk, np.zeros_like(rk), sk, np.zeros_like(sk))[0]


@pytest.mark.parametrize("bits", [None, 0, 3, 9, 13])
@pytest.mark.parametrize("lo,hi", [(1, 299), (1, 5000), (1000, 200_999),
                                   (1, 16_000_000), (1, 128_000_000),
                                   (0, 2**31 - 1), (-(1 << 30), 12345)])
def test_geometry_planners_match_jax(lo, hi, bits):
    for sf in (1.0, 0.3, 0.01):
        got = TB.plan_geometry(lo, hi, bits, sf)
        assert got == JB.plan_geometry(lo, hi, bits, sf)
        assert TB.plan_build_geometry(lo, hi, *got) == \
            JB.plan_build_geometry(lo, hi, *got)


def _build_cases():
    rng = np.random.default_rng(5)
    return [
        (rng.permutation(np.arange(1, 5001)).astype(np.int32), 1, 5000, None),
        (rng.permutation(np.arange(1, 5001)).astype(np.int32), 1, 5000, 2),
        (rng.choice(np.arange(1000, 201000), 3000, replace=False)
         .astype(np.int32), 1000, 200999, None),
        (rng.permutation(np.arange(1, 300)).astype(np.int32), 1, 299, None),
    ]


@pytest.mark.parametrize("case", range(4))
def test_build_matches_jax_build_bitmap(case):
    """The planned join's R partition + build (the phases run_join times) is
    bit-identical to the JAX package's XLA build over the cases of its own
    build test."""
    keys, lo, hi, bits = _build_cases()[case]
    pb, shift, slr = JB.plan_geometry(lo, hi, bits)
    want = jax.jit(lambda k: JB.build_bitmap(k, lo, hi, pb, shift, slr))(
        jnp.asarray(keys))
    plan = TB.plan_radix_join(keys, keys, lo, hi, device="cpu", chunk_rows=8,
                              num_radix_bits=bits, survivor_frac=1.0)
    assert (plan.rgeom.part_bits, plan.rgeom.shift, plan.r_sl_rows) == \
        (pb, shift, slr)
    assert plan.rk_in.numel() % (8 * 128) == 0
    got = plan.build(plan.r_partition()[0])
    assert got.dtype == torch.int32 and got.shape == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the twin alone agrees too, on R in any order
    np.testing.assert_array_equal(
        TB.build_bitmap(torch.from_numpy(keys), lo, hi, pb, shift,
                        slr).numpy(), np.asarray(want))


def test_probe_of_jax_bitmap_and_partition_matches_jax_count():
    """Feed the port's probe JAX's own bitmap and partitioned S (padded
    8-row slices, PAD and out-of-range keys): same count as the JAX probe
    kernel."""
    rng = np.random.default_rng(8)
    lo, hi = 1, 60000
    rk = rng.choice(np.arange(lo, hi + 1), 20000, replace=False)\
        .astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 600), rng.integers(lo, hi + 1, 900),
                         rng.integers(hi + 1, 10 * hi, 300),
                         np.full(248, PAD)]).astype(np.int32)
    rng.shuffle(sk)
    pb, shift, slr = JB.plan_geometry(lo, hi, 2)
    assert slr > 1 << (shift - 12)                 # padded slices
    bm = JB.build_bitmap(jnp.asarray(rk), lo, hi, pb, shift, slr)
    geom = JR.RadixGeom(chunk_rows=8, part_bits=pb, lo=lo, hi=hi, shift=shift)
    s_part, starts = JR.partition_pass(jnp.asarray(sk), interpret=True,
                                       geom=geom)
    nchunks = len(sk) // (8 * 128)
    st = np.asarray(starts).reshape(nchunks, -1)[:, :(1 << pb) + 1]
    pgeom = JB._probe_geom(pb, shift, slr, lo, 8, nchunks,
                           int((st[:, 1:] - st[:, :-1]).max()))
    row_d, own_d = JB.derive_descs(starts.reshape(nchunks, -1, 128), pgeom)
    want = int(JB.bitmap_probe_count(bm, s_part, row_d, own_d, pgeom,
                                     interpret=True))
    assert want == _ref_count(rk, sk)
    got = TB.bitmap_probe_count(torch.from_numpy(np.array(bm)),
                                torch.from_numpy(np.array(s_part)), lo,
                                shift, pb, slr)
    assert got.dtype == torch.int64 and int(got) == want


@pytest.mark.parametrize("q", [1.0, 0.01])
def test_plan_full_count_matches_ref_join(q):
    p = TG.WorkloadParams(r_size=3000, s_size=100_000, nthreads=4,
                          selectivity=q)
    rk, _, sk, _ = TG.build_workload(p)
    plan = TB.plan_radix_join(rk, sk, 1, 3000, device="cpu", chunk_rows=64)
    assert (plan.cap_rows is not None) == (q < 0.5)  # compaction only at q<1/2
    want = TG.expected_uniform_match_count(100_000, q)
    assert want == _ref_count(rk, sk)
    assert plan.full_count() == want
    assert int(plan.phase_fns()["probe"]()) == want
    assert set(plan.phase_fns()) == (
        {"r_partition", "build", "s_partition", "probe"}
        | ({"compact"} if q < 0.5 else set()))


def test_plan_matches_jax_plan_interpret():
    """One JAX plan in interpret mode (compaction path): same geometry and
    the same count."""
    rng = np.random.default_rng(4)
    n_r = 3000
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int32)
    sk = np.concatenate([rng.integers(1, 2 * n_r, 1500),
                         rng.integers(10 * n_r, 1 << 28, 60000)])\
        .astype(np.int32)
    rng.shuffle(sk)
    jplan = JB.plan_radix_join(jnp.asarray(rk), sk, 1, n_r, interpret=True,
                               chunk_rows=64)
    tplan = TB.plan_radix_join(rk, sk, 1, n_r, device="cpu", chunk_rows=64)
    assert tplan.cap_rows is not None
    g = jplan.geom
    assert (tplan.sgeom.part_bits, tplan.sgeom.shift, tplan.sl_rows) == \
        (g.part_bits, g.shift, g.sl_rows)
    want = jplan.full_count()
    assert want == _ref_count(rk, sk)
    assert tplan.full_count() == want


def test_deep_shift_decoupled_build_geometry():
    """Probe (0, 22, 1024) over a finer (3, 19, 128) build: the two
    partitions tile one global bitmap."""
    rng = np.random.default_rng(7)
    lo, hi = 1, 1 << 22
    rk = rng.choice(np.arange(lo, hi + 1), 4000, replace=False)\
        .astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 1500), rng.integers(lo, hi + 1, 1500),
                         rng.integers(hi + 1, 1 << 28, 27000)]).astype(np.int32)
    rng.shuffle(sk)
    plan = TB.plan_radix_join(torch.from_numpy(rk), torch.from_numpy(sk), lo,
                              hi, device="cpu", chunk_rows=16,
                              num_radix_bits=0, survivor_frac=1.0)
    assert (plan.sgeom.part_bits, plan.sgeom.shift, plan.sl_rows) == \
        (0, 22, 1024)
    assert (plan.rgeom.part_bits, plan.rgeom.shift, plan.r_sl_rows) == \
        (3, 19, 128)
    assert plan.cap_rows is None
    want = _ref_count(rk, sk)
    assert plan.full_count() == want
    assert int(plan.phase_fns()["probe"]()) == want
