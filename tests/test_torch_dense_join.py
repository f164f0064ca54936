"""PyTorch port: the dense fast path vs the JAX package.

On the CPU the wrapper runs its plain twin; the JAX Pallas kernel runs in
interpret mode.  Integer results (a count and a sum mod 2^32), so the
tolerance is zero.  The registry's dense tier is gated to CUDA tensors, so
these tests reach it through its run function.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.ops import dense_join as JD
from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
from hwbloomradixjoin_tpu_torch.data import native
from hwbloomradixjoin_tpu_torch.models import bloom_join, registry
from hwbloomradixjoin_tpu_torch.ops import dense_join as TD
from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation
from port_cpu import lean_cpu  # noqa: F401  (autouse)

PAD = -2**31


def _stream(rng, n, lo, hi):
    """S keys in [lo, hi], at lo - 1 and hi + 1, negative, far above hi and
    PAD; payloads over the whole int32 range, so the sum wraps."""
    k = rng.integers(lo, hi + 1, n).astype(np.int64)
    u = rng.random(n)
    k[u < 0.3] = rng.integers(hi + 1, 2**31, int((u < 0.3).sum()))
    k[u < 0.15] = rng.integers(-2**31 + 1, 0, int((u < 0.15).sum()))
    k[(u > 0.9) & (u < 0.93)] = lo - 1
    k[(u > 0.93) & (u < 0.96)] = hi + 1
    k[u > 0.97] = PAD
    p = rng.integers(-2**31, 2**31, n, dtype=np.int64)
    p[u > 0.8] = -2**31
    return k.astype(np.int32), p.astype(np.int32)


def _numpy(k, p, lo, hi):
    hit = (k >= lo) & (k <= hi)
    return [int(hit.sum()), int((p[hit].astype(np.int64) & 0xFFFFFFFF).sum())
            % 2**32]


@pytest.mark.parametrize("lo,hi", [(1, 3000), (1, 16_000_000),
                                   (1000, 1000)])
def test_dense_count_matches_jax_interpret(lo, hi):
    """The twin's (count, S sum) equal the Pallas kernel's, exactly."""
    rng = np.random.default_rng(hi % 1000)
    k, p = _stream(rng, 40 * 128, lo, hi)
    k[:2000] = lo + np.arange(2000) % (hi - lo + 1)  # hits, payloads 2^31 - 1
    p[:2000] = 2**31 - 1
    c, s = JD.dense_count_join(jnp.asarray(k), jnp.asarray(p), lo, hi,
                               interpret=True)
    got = TD.dense_count_join(torch.from_numpy(k), torch.from_numpy(p), lo, hi)
    assert got.dtype == torch.int64
    assert got.tolist() == [int(c), int(s)] == _numpy(k, p, lo, hi)
    raw = int(p[(k >= lo) & (k <= hi)].astype(np.int64).sum())
    assert got[0] > 0 and not 0 <= raw < 2**32      # the sum wrapped


@pytest.mark.parametrize("n", [0, 1, 7, 129, 10_001])
def test_dense_count_any_length(n):
    """The port streams flat: no multiple of 128 is needed."""
    k, p = _stream(np.random.default_rng(n), n, 5, 700)
    got = TD.dense_count_join(torch.from_numpy(k), torch.from_numpy(p), 5, 700)
    assert got.tolist() == _numpy(k, p, 5, 700)
    with pytest.raises(ValueError):
        TD.dense_count_join(torch.from_numpy(k),
                            torch.from_numpy(np.append(p, 0)), 5, 700)


def _relations(n_r=3000, n_s=20000, seed=4):
    rng = np.random.default_rng(seed)
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, n_r, dtype=np.int64).astype(np.int32)
    sk, sp = _stream(rng, n_s, 1, n_r)
    R = Relation.from_numpy(rk, rp, device="cpu",
                            stats=KeyStats(1, n_r, is_dense_pk=True,
                                           is_unique=True))
    return R, Relation.from_numpy(sk, sp, device="cpu"), (rk, rp, sk, sp)


@pytest.mark.parametrize("bloom", [None, "blocked", "basic"])
def test_dense_tier_matches_ref_join(bloom):
    """The dense tier's count and S checksum equal ref_join's, with and
    without a filter (which has no false negatives, so it changes neither);
    with one, S-tuples after filter are the plain prune's."""
    R, S, (rk, rp, sk, sp) = _relations()
    args = None if bloom is None else BloomArgs(
        variant=BloomVariant(bloom), m=1 << 16, k=2, B=512)
    want = native.ref_join(rk, rp, sk, sp)
    res, st, sums = registry._run_plan(
        registry.DensePlan.of(R, S, args, (1, 3000)), "dense", S, 2)
    assert st.tier == "dense"
    assert res.count() == st.result == want[0]
    assert sums == (0, want[2] % 2**32)
    if args is None:
        assert list(st.phases) == ["probe"] and res.s_after_filter is None
    else:
        assert list(st.phases) == ["bloom_build", "bloom_probe", "probe"]
        n = int(bloom_join.bloom_prune(R.key, S.key, args)[1])
        assert res.s_after_filter == st.s_after_filter == n < len(sk)
        assert st.build_usec == st.phases["bloom_build"]
        assert st.part_usec == st.phases["bloom_probe"]
    assert st.probe_usec == st.phases["probe"] and st.total_usec > 0


class _CudaKey:
    """A key column that reports a CUDA device: select_tier reads its
    device only, never its values."""

    device = torch.device("cuda")


def test_select_tier_takes_dense_on_the_card_only():
    """The default config sends the generator's dense PK to the dense tier
    for a relation on the card and to the kernel tier for one on the CPU;
    allow_dense=False and materialize turn it off."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig

    R, _, _ = _relations(n_r=500)
    on_card = dataclasses.replace(R, key=_CudaKey())
    spec = registry.ALGORITHMS["PRO"]
    assert registry.select_tier(spec, R, EngineConfig(), (1, 500)) \
        == "cuda_radix"
    assert registry.select_tier(spec, on_card, EngineConfig(), (1, 500)) \
        == "dense"
    assert registry.select_tier(spec, on_card, EngineConfig(
        allow_dense=False), (1, 500)) == "cuda_radix"
    assert registry.select_tier(spec, on_card, EngineConfig(
        materialize=True), (1, 500)) == "materialize"
