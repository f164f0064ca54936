"""PyTorch port: data layer and table types against the JAX package.

The port copies the uniform generators (numpy only) and the rand()-driven
non-unique and full-range ones (through its copy of the native binding);
they must emit exactly the JAX package's arrays, and relations must cross
between the packages through numpy unchanged.
"""

import os

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.data import generator as JG
from hwbloomradixjoin_tpu.types import KeyStats as JKeyStats
from hwbloomradixjoin_tpu.types import Relation as JRelation
from hwbloomradixjoin_tpu_torch.data import generator as TG
from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation
from port_cpu import lean_cpu  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "relations_golden.npz")


@pytest.mark.parametrize("n,nthreads,maxid,threshold,q,seed", [
    (37, 3, 37, 37, 1.0, None),
    (101, 3, JG.INT_MAX, 37, 0.7, 5),
    (54321, 7, JG.INT_MAX, 12345, 0.999, 11),
    (200_000, 8, JG.INT_MAX, 25_000, 0.01, 54321),
    (100_000, 4, 100_000, 100_000, 1.0, 12345),
])
def test_parallel_create_relation_matches_jax(n, nthreads, maxid, threshold,
                                              q, seed):
    want_k, want_p = JG.parallel_create_relation(n, nthreads, maxid,
                                                 threshold, q,
                                                 shuffle_seed=seed)
    got_k, got_p = TG.parallel_create_relation(n, nthreads, maxid, threshold,
                                               q, shuffle_seed=seed)
    assert got_k.dtype == np.int32 and got_p.dtype == np.int32
    np.testing.assert_array_equal(got_k, want_k)
    np.testing.assert_array_equal(got_p, want_p)


def test_uniform_golden_multisets():
    golden = np.load(FIXTURE)
    rk, _ = TG.parallel_create_relation(37, 3, 37, 37, 1.0)
    assert np.array_equal(np.sort(rk), np.sort(golden["tiny_rk"]))
    sk, _ = TG.parallel_create_relation(101, 3, TG.INT_MAX, 37, 0.7)
    assert np.array_equal(np.sort(sk), np.sort(golden["tiny_sk"]))
    sk, _ = TG.parallel_create_relation(54321, 7, TG.INT_MAX, 12345, 0.999)
    assert np.array_equal(np.sort(sk), np.sort(golden["odd_sk"]))


@pytest.mark.parametrize("q", [1.0, 0.5, 0.01])
def test_build_workload_matches_jax(q):
    jp = JG.WorkloadParams(r_size=3000, s_size=20000, nthreads=4,
                           selectivity=q)
    tp = TG.WorkloadParams(r_size=3000, s_size=20000, nthreads=4,
                           selectivity=q)
    for want, got in zip(JG.build_workload(jp), TG.build_workload(tp)):
        np.testing.assert_array_equal(got, want)
    sk = TG.build_workload(tp)[2]
    assert int(((sk >= 1) & (sk <= 3000)).sum()) == \
        TG.expected_uniform_match_count(20000, q)
    js, ts = JG.r_key_stats(jp), TG.r_key_stats(tp)
    assert (ts.min_key, ts.max_key, ts.is_dense_pk, ts.is_unique) == \
        (js.min_key, js.max_key, js.is_dense_pk, js.is_unique)


@pytest.mark.parametrize("kw", [dict(skew=1.0), dict(skew=0.75),
                                dict(skew=0.25)])
def test_unported_generators_raise(kw):
    """Zipf S sides, which raised until the port's command line needed them,
    emit exactly the JAX package's arrays: S Zipf over [1, r_size], every S
    key in R."""
    base = dict(r_size=300, s_size=2000, r_seed=5, s_seed=6)
    got = TG.build_workload(TG.WorkloadParams(**base, **kw))
    want = JG.build_workload(JG.WorkloadParams(**base, **kw))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[2].min() >= 1 and got[2].max() <= 300


@pytest.mark.parametrize("kw", [
    dict(nonunique_keys=True), dict(nonunique_keys=True, selectivity=0.4),
    dict(nonunique_keys=True, skew=1.0),      # non-unique wins over skew
    dict(fullrange_keys=True, r_size=2000, s_size=9000),
    dict(fullrange_keys=True, selectivity=0.001),
    dict(nonunique_keys=True, r_size=200_000, s_size=1000)])
def test_nonunique_and_fullrange_workloads_match_jax(kw):
    """The rand()-driven generators emit exactly the JAX package's arrays,
    and declare no key constraint."""
    base = dict(r_size=3000, s_size=20000, r_seed=5, s_seed=6)
    tp = TG.WorkloadParams(**{**base, **kw})
    jp = JG.WorkloadParams(**{**base, **kw})
    got, want = TG.build_workload(tp), JG.build_workload(jp)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert TG.r_key_stats(tp) is None and JG.r_key_stats(jp) is None


@pytest.mark.parametrize("s,q", [(400_000, 0.25), (54321, 0.999),
                                 (128_000_000, 1.0), (128_000_000, 0.01)])
def test_expected_match_count_matches_jax(s, q):
    assert TG.expected_uniform_match_count(s, q) == \
        JG.expected_uniform_match_count(s, q)


def test_relation_crosses_packages():
    rng = np.random.default_rng(1)
    rk = rng.permutation(np.arange(1, 501)).astype(np.int32)
    rp = rng.integers(0, 2**31 - 1, 500).astype(np.int32)
    jr = JRelation.from_numpy(rk, rp, stats=JKeyStats(1, 500, True, True))
    k, p = jr.to_numpy()
    st = jr.stats
    tr = Relation.from_numpy(k, p, device="cpu", stats=KeyStats(
        st.min_key, st.max_key, st.is_dense_pk, st.is_unique))
    assert tr.key.dtype == torch.int32 and tr.capacity == 500
    np.testing.assert_array_equal(tr.to_numpy()[0], rk)
    np.testing.assert_array_equal(tr.to_numpy()[1], rp)
    assert tr.stats.is_unique and tr.stats.max_key == 500


def test_relation_key8b_columns_match_jax():
    rng = np.random.default_rng(2)
    k = rng.integers(-2**40, 2**40, 300).astype(np.int64)
    p = rng.integers(0, 2**40, 300).astype(np.int64)
    jr = JRelation.from_numpy(k, p, key8b=True)
    tr = Relation.from_numpy(k, p, device="cpu", key8b=True)
    for name in ("key", "key_hi", "payload", "payload_hi"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)))
