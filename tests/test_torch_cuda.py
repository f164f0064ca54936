"""PyTorch port on the card: each CUDA kernel against its plain twin.

Every test takes the `cuda` fixture and skips where no CUDA device exists (a
CUDA kernel has no CPU mode); chip_smoke.py covers the main path's geometry,
these cover the edges: tiny and odd chunks, 0 to 13 partition bits, pad
category dropped, no range prune, negative and near-2^31 key ranges, padded
and deep bitmap slices, payloads moved with the keys, count tables from
empty chunks and from every key in one slot, probes with and without S
payloads, and the launch counters.  This file imports no jax, so on a
machine without it run:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
from hwbloomradixjoin_tpu_torch.ops import prho_join as P
from hwbloomradixjoin_tpu_torch.ops import radix as X

PAD = -2**31


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _keys(rng, n, lo, hi):
    k = rng.integers(lo, hi + 1, n).astype(np.int64)
    u = rng.random(n)
    k[u < 0.2] = rng.integers(hi + 1, 2**31, int((u < 0.2).sum())) \
        if hi < 2**31 - 1 else PAD
    k[u < 0.1] = rng.integers(-2**31 + 1, lo, int((u < 0.1).sum())) \
        if lo > -2**31 + 1 else PAD
    k[u > 0.93] = PAD
    return torch.from_numpy(k.astype(np.int32))


@pytest.mark.parametrize("chunk_rows,nchunks", [(8, 3), (40, 2), (4096, 2)])
@pytest.mark.parametrize("part_bits,lo,hi,pad_cat", [
    (0, 1, 3000, True),
    (3, 100, 5099, False),
    (6, 1, 16_000_000, True),
    (9, 1, 128_000_000, True),
    (13, -(1 << 24), (1 << 24) - 1, True),
    (13, (1 << 31) - (1 << 25), 2**31 - 1, True),
    (5, 0, (1 << 24) - 1, None),               # hi None: no range prune
])
def test_partition_kernel_matches_twin(cuda, chunk_rows, nchunks, part_bits,
                                       lo, hi, pad_cat):
    rng = np.random.default_rng(part_bits * 7 + chunk_rows)
    keys = _keys(rng, nchunks * chunk_rows * 128, lo, hi).to(cuda)
    range_bits = max((hi - lo).bit_length(), 12)
    geom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits, lo=lo,
                       hi=None if pad_cat is None else hi,
                       shift=range_bits - part_bits,
                       pad_cat=pad_cat is not False)
    got_k, got_s = X.partition_pass(keys, geom)
    want_k, want_s = X.partition_pass_plain(keys, geom)
    torch.cuda.synchronize()
    assert torch.equal(got_k, want_k)
    assert torch.equal(got_s, want_s)


@pytest.mark.parametrize("chunk_rows,cap_rows", [(8, None), (16, 8),
                                                 (4096, 48), (4096, None)])
def test_compact_kernel_matches_twin(cuda, chunk_rows, cap_rows):
    rng = np.random.default_rng(chunk_rows + (cap_rows or 0))
    keys = _keys(rng, 3 * chunk_rows * 128, 1000, 50_000).to(cuda)
    got = X.compact_pass(keys, 1000, 50_000, chunk_rows, cap_rows)
    want = X.compact_pass_plain(keys, 1000, 50_000, chunk_rows, cap_rows)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("lo,hi,bits", [
    (1, 299, None), (1, 60000, 2), (1000, 200_999, None),
    (1, 1 << 22, 0), (-(1 << 20), (1 << 20) - 1, 4),
    ((1 << 31) - (1 << 24), 2**31 - 1, 6),
])
def test_build_and_probe_kernels_match_twins(cuda, lo, hi, bits):
    rng = np.random.default_rng(abs(lo) % 1000 + hi % 1000)
    span = hi - lo + 1
    rk = (rng.choice(span, min(span // 3, 200_000), replace=False)
          + lo).astype(np.int32)
    pb, shift, slr = B.plan_geometry(lo, hi, bits)
    rb, rshift, rslr = B.plan_build_geometry(lo, hi, pb, shift, slr)
    r_in = X._chunk_pad(rk, 64 * 128, cuda)
    rgeom = X.RadixGeom(chunk_rows=64, part_bits=rb, lo=lo, hi=hi,
                        shift=rshift, pad_cat=not X.pad_cat_safe(lo, hi))
    r_part = X.partition_pass(r_in, rgeom)[0]
    bm = B.bitmap_build(r_part, lo, hi, rb, rshift, rslr)
    assert torch.equal(bm, B.build_bitmap(r_part, lo, hi, rb, rshift, rslr))

    sk = torch.cat([torch.from_numpy(rng.choice(rk, 5000)),
                    _keys(rng, 3 * 64 * 128 - 5000, lo, hi)]).to(cuda)
    sgeom = X.RadixGeom(chunk_rows=64, part_bits=pb, lo=lo, hi=hi,
                        shift=shift)
    s_part = X.partition_pass(sk, sgeom)[0]
    got = B.bitmap_probe_count(bm, s_part, lo, shift, pb, slr)
    want = B.bitmap_probe_count_plain(bm, s_part, lo, shift, pb, slr)
    truth = int(np.isin(sk.cpu().numpy(), rk).sum())
    assert int(got) == int(want) == truth


def test_plan_on_card_equals_plan_on_cpu(cuda):
    rng = np.random.default_rng(11)
    rk = rng.permutation(np.arange(1, 40001)).astype(np.int32)
    for q_hi in (41_000, 8_000_000):                  # direct, compacted
        sk = rng.integers(1, q_hi, 700_000).astype(np.int32)
        on_card = B.plan_radix_join(rk, sk, 1, 40000, device=cuda)
        on_cpu = B.plan_radix_join(rk, sk, 1, 40000, device="cpu")
        assert on_card.cap_rows == on_cpu.cap_rows
        assert on_card.full_count() == on_cpu.full_count() \
            == int(np.isin(sk, rk).sum())


def test_launch_counts_and_input_checks(cuda):
    geom = X.RadixGeom(chunk_rows=8, part_bits=2, lo=0, hi=4095, shift=10)
    keys = torch.arange(8 * 128, dtype=torch.int32)
    _build.reset_launches()
    X.partition_pass(keys, geom)                      # CPU twin: not counted
    X.partition_pass(keys.to(cuda), geom)
    X.compact_pass(keys.to(cuda), 0, 100, 8)
    assert _build.LAUNCHES == {"partition": 1, "compact": 1,
                               "bitmap_build": 0, "bitmap_probe": 0,
                               "partition_kv": 0, "table_build": 0,
                               "table_probe": 0}
    with pytest.raises(ValueError):
        X.partition_pass(keys.to(cuda).long(), geom)
    with pytest.raises(ValueError):
        X.partition_pass(torch.arange(8 * 129, dtype=torch.int32,
                                      device=cuda)[1:8 * 128 + 1], geom)


@pytest.mark.parametrize("chunk_rows,part_bits,lo,hi", [
    (8, 0, 1, 3000), (40, 5, 1, 5000), (4096, 13, 1, 128_000_000),
    (64, 13, -(1 << 20), (1 << 20) - 1)])
def test_partition_kv_kernel_matches_twin(cuda, chunk_rows, part_bits, lo,
                                          hi):
    rng = np.random.default_rng(part_bits + chunk_rows)
    n = 3 * chunk_rows * 128
    keys = _keys(rng, n, lo, hi).to(cuda)
    pays = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                            .astype(np.int32)).to(cuda)
    shift = max((hi - lo).bit_length(), 7) - part_bits
    geom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits, lo=lo,
                       hi=hi, shift=shift)
    got = X.partition_pass_kv(keys, pays, geom)
    want = X.partition_pass_kv_plain(keys, pays, geom)
    keys_only = X.partition_pass(keys, geom)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[0], keys_only[0])
    assert torch.equal(got[2], keys_only[1])


def _tables_and_probe(cuda, rk, rp, sk, sp, lo, hi, bits=None):
    pb, shift, slr = P.plan_geometry_counts(lo, hi, bits)
    geom = X.RadixGeom(chunk_rows=8, part_bits=pb, lo=lo, hi=hi, shift=shift)
    r_part = X.partition_pass_kv(X._chunk_pad(rk, 1024, cuda),
                                 X._chunk_pad(rp, 1024, cuda), geom)
    tables = P.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr)
    want_t = P.build_tables(r_part[0], r_part[1], lo, hi, pb, shift, slr)
    assert torch.equal(tables[0], want_t[0])
    assert torch.equal(tables[1], want_t[1])
    s_part = X.partition_pass_kv(X._chunk_pad(sk, 1024, cuda),
                                 X._chunk_pad(sp, 1024, cuda), geom)
    sums = []
    for s_pay in (s_part[1], None):
        args = (*tables, s_part[0], s_pay, lo, shift, pb, slr)
        got = P.probe_count_sums(*args)
        assert torch.equal(got, P.probe_count_sums_plain(*args))
        sums.append(got.tolist())
    return tables, sums


def _ref_sums(rk, rp, sk, sp):
    """(count, r_sum, s_sum) mod 2^32 of the join, in numpy."""
    keys, inv = np.unique(rk, return_inverse=True)
    cnt = np.bincount(inv).astype(np.int64)
    rsum = np.bincount(inv, weights=rp.astype(np.int64) & 0xFFFFFFFF)
    pos = np.clip(np.searchsorted(keys, sk), 0, len(keys) - 1)
    hit = keys[pos] == sk
    c = np.where(hit, cnt[pos], 0)
    r = int(np.where(hit, rsum[pos], 0).sum()) % 2**32
    s = int(((sp.astype(np.int64) & 0xFFFFFFFF) * c).sum()) % 2**32
    return [int(c.sum()), r, s]


def test_table_kernels_every_key_in_one_slot(cuda):
    """All of R in one slot: the count and the wrapped payload sum of 9000
    atomics, probed by S with PAD and out-of-range keys."""
    rng = np.random.default_rng(21)
    rk = np.full(9000, 777, np.int32)
    rp = rng.integers(-2**31, 2**31, 9000, dtype=np.int64).astype(np.int32)
    sk = np.array([777] * 50 + [778, 1, 3000, -5, PAD, 2**31 - 1] * 10,
                  np.int32)
    sp = rng.integers(-2**31, 2**31, len(sk), dtype=np.int64).astype(np.int32)
    tables, (with_sp, keys_only) = _tables_and_probe(cuda, rk, rp, sk, sp,
                                                     1, 3000)
    assert int(tables[0].max()) == 9000 and int((tables[0] != 0).sum()) == 1
    assert with_sp == _ref_sums(rk, rp, sk, sp)
    assert keys_only == with_sp[:2] + [0]


def test_table_kernels_empty_chunks(cuda):
    """Chunks holding PAD only (R and S): zero tables, zero sums."""
    pad = np.full(3 * 1024, PAD, np.int32)
    tables, sums = _tables_and_probe(cuda, pad, pad, pad, pad, 1, 5000, 3)
    assert int(tables[0].abs().sum()) == 0 and int(tables[1].abs().sum()) == 0
    assert sums == [[0, 0, 0], [0, 0, 0]]


@pytest.mark.parametrize("lo,hi,bits", [(1, 299, None), (1, 60000, 4),
                                        (-(1 << 20), (1 << 20) - 1, 6),
                                        (1000, 1000 + (1 << 22), None)])
def test_table_kernels_match_twins(cuda, lo, hi, bits):
    rng = np.random.default_rng(abs(lo) % 997 + hi % 997)
    rk = rng.integers(lo, hi + 1, 20_000).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, len(rk), dtype=np.int64).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 7000),
                         _keys(rng, 9000, lo, hi).numpy()])
    sp = rng.integers(-2**31, 2**31, len(sk), dtype=np.int64).astype(np.int32)
    _, (with_sp, keys_only) = _tables_and_probe(cuda, rk, rp, sk, sp, lo, hi,
                                                bits)
    assert with_sp == _ref_sums(rk, rp, sk, sp)
    assert keys_only == with_sp[:2] + [0]


def test_prho_plan_on_card_equals_plan_on_cpu(cuda):
    rng = np.random.default_rng(12)
    rk = rng.integers(1, 40_000, 60_000).astype(np.int32)
    rp = rng.integers(0, 2**31, len(rk)).astype(np.int32)
    sk = rng.integers(-100, 50_000, 700_000).astype(np.int32)
    sp = rng.integers(0, 2**31, len(sk)).astype(np.int32)
    for plan_fn, args in ((P.plan_prho_join, (rk, rp, sk, sp)),
                          (P.plan_prh_join, (rk, rp, sk))):
        on_card = plan_fn(*args, 1, 39_999, device=cuda).full_sums()
        on_cpu = plan_fn(*args, 1, 39_999, device="cpu").full_sums()
        assert on_card == on_cpu
    want = _ref_sums(rk, rp, sk, sp)
    assert list(P.plan_prho_join(rk, rp, sk, sp, 1, 39_999,
                                 device=cuda).full_sums()) == want
