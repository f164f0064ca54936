"""PyTorch port on the card: each CUDA kernel against its plain twin.

Every test takes the `cuda` fixture and skips where no CUDA device exists (a
CUDA kernel has no CPU mode); chip_smoke.py covers the main path's geometry,
these cover the edges: tiny and odd chunks, 0 to 20 partition bits in one
pass (one sweep and digit passes; all-PAD and one-category chunks), pad
category dropped, no range prune, negative and near-2^31 key ranges, padded
and deep bitmap slices, payloads moved with the keys, count tables from
empty chunks and from every key in one slot (every slice size, a key 64,999
times, no starts refused), probes with and without S
payloads, the hash-mode partition, pass 2 in both modes (all PAD, one chunk,
empty buckets, b2 = 1, 2, 3, 6 and 10, spans of several chunks whose windows
do not divide into tiles, runs of 0 and 1 keys, regions truncated at their
capacity), the bloom probe (k = 1..8, B = 32 to 2^17, no survivors),
the filter build (both variants, k = 1 to 8, B = 32 to 2^17, m = 2^10 to
2^30, the flagship's filter over 16M keys against the benchmark's
reference positions, 1 to 7 keys at each 4-byte offset, empty and all-PAD
R, one launch a call, int64 and strided keys refused),
the prune past the TPU's limits (2,049 chunks, a hot key), the bitmap build
walking R's runs in every split (1 to 8 CTAs a range, 1 to 64 buckets a
range; pad category on and off, a duplicate-heavy
R, keys at lo - 1, lo, hi and hi + 1, PAD and negative keys, empty buckets
and one bucket holding every key, 4d's and the flagship's geometries, the
slice padding over a sentinel-filled allocator, runs at another geometry
and in-range keys in the pad run, which take the last CTA's global pass;
its flat class past the staging budget, no starts refused), the bitmap and
bloom probes walking a partition's runs in every class and split (bucket
ranges of 1, 3 and 4 buckets, spans of 1, 2 and every segment, 1 to 512
lanes a run; chunks and pass-2 regions with their tails; runs of 0 and 1
keys, an all-PAD and a one-bucket segment, keys below lo, above hi inside
the last bucket and past it; empty and full bitmaps and filters; an output
pre-filled with a sentinel; the flat classes past the staging budget and
without starts, and the bitmap probe's for small live slices and a small S;
no starts refused by the bitmap probe), the dense count
(odd lengths, wrapping sums, all PAD), materialization (payloads at -2^31,
PAD, empty buckets), the probe and materialization over bucket ranges
(every slice size, 1 to 16 buckets a CTA, one bucket holding all of S, a pad
category covering most of S over a sentinel-filled allocator, no starts
refused), the gathered probe (duplicates, empty buckets, a largest bucket
of 1 key and of one below, at and one past its capacity, every capacity
class of its hash table in one call, runs of 0 and 1 keys, the radix count
geometry at 2M x 8M keys), the default config's dense tier, the launch
counters, the standalone operators (radix_cluster, radix_sort,
group_by_key, join_group_count), the sync-free local join, the distributed
join on a world of one over NCCL and materialize8b's all pairs.  This file imports no jax, so on a machine without it run:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
from hwbloomradixjoin_tpu_torch.ops import bloom
from hwbloomradixjoin_tpu_torch.ops import bloom_pallas as BP
from hwbloomradixjoin_tpu_torch.ops import dense_join as D
from hwbloomradixjoin_tpu_torch.ops import multipass as M
from hwbloomradixjoin_tpu_torch.ops import prho_join as P
from hwbloomradixjoin_tpu_torch.ops import hashes
from hwbloomradixjoin_tpu_torch.ops import radix as X
from hwbloomradixjoin_tpu_torch.ops import run_split

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
    r_part, r_starts = X.partition_pass(r_in, rgeom)
    bm = B.bitmap_build(r_part, lo, hi, rb, rshift, rslr, r_starts)
    assert torch.equal(bm, B.build_bitmap(r_part, lo, hi, rb, rshift, rslr))

    sk = torch.cat([torch.from_numpy(rng.choice(rk, 5000)),
                    _keys(rng, 3 * 64 * 128 - 5000, lo, hi)]).to(cuda)
    sgeom = X.RadixGeom(chunk_rows=64, part_bits=pb, lo=lo, hi=hi,
                        shift=shift)
    s_part, s_starts = X.partition_pass(sk, sgeom)
    got = B.bitmap_probe_count(bm, s_part, lo, shift, pb, slr, s_starts)
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
                               "table_probe": 0, "partition_hash": 0,
                               "pass2_partition": 0,
                               "pass2_partition_hash": 0, "bloom_probe": 0,
                               "dense_count": 0, "materialize": 0,
                               "gathered_probe": 0, "bloom_build": 0}
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


_WIDE_BITS = [1, 6, 10, 12, 13, 14, 17, 20]


def _wide_geom(mode, chunk_rows, part_bits):
    """Range mode over [1, 2^21 + 5] (the pad category kept or dropped), or
    hash mode over part_bits + 4 block bits."""
    if mode == "hash":
        return X.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits,
                           hash_seed=0x9E3779B9,
                           hash_bits=min(part_bits + 4, 31))
    return X.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits, lo=1,
                       hi=(1 << 21) + 5, shift=22 - part_bits,
                       pad_cat=mode != "range_nopad")


def _partition_both(cuda, keys, pays, geom):
    """Kernel against twin, keys only and (pays set) with payloads."""
    keys = keys.to(cuda)
    if pays is None:
        got, want = X.partition_pass(keys, geom), \
            X.partition_pass_plain(keys, geom)
    else:
        pays = pays.to(cuda)
        got = X.partition_pass_kv(keys, pays, geom)
        want = X.partition_pass_kv_plain(keys, pays, geom)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("chunk_rows,nchunks", [(8, 3), (24, 2), (40, 2),
                                                (4096, 2)])
@pytest.mark.parametrize("part_bits", _WIDE_BITS)
@pytest.mark.parametrize("mode", ["range", "range_nopad", "hash", "kv"])
def test_partition_kernel_every_width(cuda, chunk_rows, nchunks, part_bits,
                                      mode):
    """One pass at 1 to 20 bits: one sweep up to 8 bits, digit passes past
    it; chunks smaller than a 4,096-key CTA tile (8, 24 rows), one and a
    quarter tiles (40 rows) and 128 tiles; keys below lo and above hi,
    PAD; bit for bit against the twins."""
    rng = np.random.default_rng(part_bits * 31 + chunk_rows)
    n = nchunks * chunk_rows * 128
    if mode == "hash":
        keys = _hash_keys(rng, n)
    else:
        keys = _keys(rng, n, 1, (1 << 21) + 5)
    pays = None
    if mode == "kv":
        pays = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                                .astype(np.int32))
    geom = _wide_geom("range" if mode == "kv" else mode, chunk_rows,
                      part_bits)
    _partition_both(cuda, keys, pays, geom)


@pytest.mark.parametrize("part_bits", [6, 13, 17])
@pytest.mark.parametrize("mode", ["range", "range_nopad", "hash"])
def test_partition_kernel_pad_and_one_category_chunks(cuda, part_bits, mode):
    """Chunk 0 all PAD, chunk 1 one key over and over (one category), chunk 2
    mixed, with payloads."""
    rng = np.random.default_rng(part_bits)
    chunk = 40 * 128
    keys = torch.cat([torch.full((chunk,), PAD, dtype=torch.int32),
                      torch.full((chunk,), 777_777, dtype=torch.int32),
                      _keys(rng, chunk, 1, (1 << 21) + 5)])
    pays = torch.arange(3 * chunk, dtype=torch.int32)
    geom = _wide_geom(mode, 40, part_bits)
    _, _, starts = _partition_both(cuda, keys, pays, geom)
    st = starts.view(3, -1).cpu()
    cat_pad = 1 << part_bits if geom.pad_cat else None
    if cat_pad is not None:
        assert (st[0, :cat_pad + 1] == 0).all() and (st[0, cat_pad + 1:]
                                                     == chunk).all()
    _partition_both(cuda, keys, None, geom)


def _tables_and_probe(cuda, rk, rp, sk, sp, lo, hi, bits=None,
                      chunk_rows=8):
    pb, shift, slr = P.plan_geometry_counts(lo, hi, bits)
    chunk = chunk_rows * 128
    geom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=pb, lo=lo, hi=hi,
                       shift=shift)
    r_part = X.partition_pass_kv(X._chunk_pad(rk, chunk, cuda),
                                 X._chunk_pad(rp, chunk, cuda), geom)
    tables = P.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr,
                           r_part[2])
    want_t = P.build_tables(r_part[0], r_part[1], lo, hi, pb, shift, slr)
    assert torch.equal(tables[0], want_t[0])
    assert torch.equal(tables[1], want_t[1])
    s_part = X.partition_pass_kv(X._chunk_pad(sk, chunk, cuda),
                                 X._chunk_pad(sp, chunk, cuda), geom)
    sums = []
    for s_pay in (s_part[1], None):
        args = (*tables, s_part[0], s_pay, lo, shift, pb, slr)
        got = P.probe_count_sums(*args, s_part[2])
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


@pytest.mark.parametrize("bits", [13, 10, 6])         # shift 7, 10, 14
def test_table_build_kernel_every_slice_size(cuda, bits):
    """slice_rows 8 (shift 7: each slice 7/8 tail), 8 (shift 10) and 128
    (shift 14), with R leaving buckets empty, a hot key repeated
    64,999 times (the most the multiplicity guard lets through), PAD and
    out-of-range keys: bit for bit against build_tables."""
    rng = np.random.default_rng(bits)
    lo, hi = 1, 1 << 20
    pb, shift, slr = P.plan_geometry_counts(lo, hi, bits)
    assert (pb, shift) == (bits, 20 - bits)
    rk = np.concatenate([np.full(64_999, 4242, np.int32),     # one slot
                         rng.integers(lo, hi // 16, 30_000).astype(np.int32),
                         np.repeat(np.array([PAD, 0, -5, hi + 1, 2**31 - 1],
                                            np.int32), 100)])
    rp = rng.integers(-2**31, 2**31, len(rk), dtype=np.int64).astype(np.int32)
    geom = X.RadixGeom(chunk_rows=40, part_bits=pb, lo=lo, hi=hi, shift=shift)
    r_part = X.partition_pass_kv(X._chunk_pad(rk, 40 * 128, cuda),
                                 X._chunk_pad(rp, 40 * 128, cuda), geom)
    got = P.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr,
                        r_part[2])
    want = P.build_tables(r_part[0], r_part[1], lo, hi, pb, shift, slr)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[0].max()) == int((rk == 4242).sum()) >= 64_999
    # keys in the first sixteenth of the range: the other buckets are empty
    assert int((got[0].view(1 << pb, -1).sum(1) == 0).sum()) \
        == (1 << pb) - (1 << pb) // 16


def test_table_build_kernel_all_pad_and_needs_starts(cuda):
    """An all-PAD R gives zero tables; the card refuses a build without the
    partition's starts."""
    pad = np.full(3 * 1024, PAD, np.int32)
    pb, shift, slr = P.plan_geometry_counts(1, 5000, 3)
    geom = X.RadixGeom(chunk_rows=8, part_bits=pb, lo=1, hi=5000, shift=shift)
    r_part = X.partition_pass_kv(X._chunk_pad(pad, 1024, cuda),
                                 X._chunk_pad(pad, 1024, cuda), geom)
    cnt, pay = P.table_build(r_part[0], r_part[1], 1, 5000, pb, shift, slr,
                             r_part[2])
    assert int(cnt.abs().sum()) == 0 and int(pay.abs().sum()) == 0
    with pytest.raises(ValueError, match="starts"):
        P.table_build(r_part[0], r_part[1], 1, 5000, pb, shift, slr)


def _range_case(cuda, rk, rp, sk, sp, lo, hi, bits, chunk_rows):
    """A unique R: the probe (with and without S payloads) and
    materialization over bucket ranges, each equal to its twin; returns
    the probe's sums with payloads and the images."""
    _, (with_sp, keys_only) = _tables_and_probe(cuda, rk, rp, sk, sp, lo, hi,
                                                bits, chunk_rows)
    assert keys_only == with_sp[:2] + [0]
    return with_sp, _materialize_case(cuda, rk, rp, sk, sp, lo, hi, bits,
                                      chunk_rows)


def _unique_case(rng, lo, hi, n_r, n_s):
    """A unique R over [lo, hi] (its ends included) and an S of hits,
    misses, keys below lo, above hi inside the last bucket and past it,
    and PAD."""
    rk = (rng.choice(hi - lo + 1, n_r, replace=False) + lo).astype(np.int32)
    rk[:2] = [lo, hi]
    rp = rng.integers(-2**31, 2**31, n_r, dtype=np.int64).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, n_s // 2),
                         _keys(rng, n_s - n_s // 2 - 40, lo, hi).numpy(),
                         np.repeat(np.array([lo - 1, hi + 1, PAD], np.int32),
                                   10), np.full(10, hi, np.int32)])
    sp = rng.integers(-2**31, 2**31, len(sk), dtype=np.int64).astype(np.int32)
    return rk, rp, sk, sp


@pytest.mark.parametrize("chunk_rows", [8, 4096])
@pytest.mark.parametrize("lo,hi,bits", [
    (1, (1 << 21) - 3, b) for b in range(7, 15)] + [
    (5, (1 << 24) + 1, b) for b in (14, 17)])
def test_range_kernels_every_slice_size(cuda, chunk_rows, lo, hi, bits):
    """Shift 14 down to 7 (slices of 2^14 slots, one bucket a CTA, to 1,024
    slots, 16 a CTA) over [1, 2^21 - 3], and 14 and 17 bits over a 2^24
    span (several buckets a CTA, 131,072 buckets): the probe and
    materialization equal their twins and ref_join's sums; hi leaves the
    last bucket part empty, so S's keys above hi inside it reach the
    arithmetic test."""
    from hwbloomradixjoin_tpu_torch.data import native
    rng = np.random.default_rng(bits * 17 + chunk_rows)
    pb, shift, _ = P.plan_geometry_counts(lo, hi, bits)
    assert pb == bits
    rk, rp, sk, sp = _unique_case(rng, lo, hi, 20_000, 60_000)
    top = lo + ((1 << pb) << shift)
    sk[-30:-20] = rng.integers(hi + 1, top, 10)   # above hi, below F's end
    sums, out = _range_case(cuda, rk, rp, sk, sp, lo, hi, bits, chunk_rows)
    c, r, s = native.ref_join(rk, rp, sk, sp)
    assert sums == [c, r % 2**32, s % 2**32] and int(out[3]) == c


@pytest.mark.parametrize("chunk_rows", [8, 4096])
def test_range_kernels_one_bucket_all_pad_and_empty_buckets(cuda, chunk_rows):
    """All of S in bucket 0 (one CTA walks every key), R and S in the
    first buckets only (the other CTAs walk empty runs), and an all-PAD S
    (zero sums, PAD images)."""
    rng = np.random.default_rng(chunk_rows)
    lo, hi = 1, 1 << 22
    pb, shift, _ = P.plan_geometry_counts(lo, hi, 10)
    rk = np.arange(lo, lo + (1 << shift), 3, dtype=np.int32)   # bucket 0
    rp = rng.integers(-2**31, 2**31, len(rk), dtype=np.int64).astype(np.int32)
    sk = rng.integers(lo, lo + (1 << shift), 50_000).astype(np.int32)
    sp = rng.integers(-2**31, 2**31, len(sk), dtype=np.int64).astype(np.int32)
    sums, out = _range_case(cuda, rk, rp, sk, sp, lo, hi, 10, chunk_rows)
    hits = int(np.isin(sk, rk).sum())
    assert sums[0] == int(out[3]) == hits > 10_000
    sk2 = rng.integers(lo, lo + 3 * (1 << shift), 50_000).astype(np.int32)
    sums, out = _range_case(cuda, rk, rp, sk2, sp, lo, hi, 10, chunk_rows)
    assert sums[0] == int(np.isin(sk2, rk).sum())
    pad = np.full(7000, PAD, np.int32)
    sums, out = _range_case(cuda, rk, rp, pad, sp[:7000], lo, hi, 10,
                            chunk_rows)
    assert sums == [0, 0, 0] and all((o == PAD).all() for o in out[:3])


def test_materialize_pad_category_over_a_sentinel(cuda):
    """q = 0.01-like S (99 % outside [lo, hi]: the pad runs cover most of
    every 2^19-key chunk, spread over many fill CTAs): with the caching
    allocator's blocks of the images' size filled with a sentinel first,
    every image slot is written (equal to the twin, no sentinel left)."""
    rng = np.random.default_rng(99)
    lo, hi = 1, 1 << 20
    rk = (rng.choice(hi, 200_000, replace=False) + 1).astype(np.int32)
    rp = rng.integers(-2**31, 2**31, len(rk), dtype=np.int64).astype(np.int32)
    n = 3 * 4096 * 128
    sk = rng.integers(hi + 1, 2**31 - 1, n).astype(np.int32)
    live = rng.random(n) < 0.01
    sk[live] = rng.choice(rk, int(live.sum()))
    sk[-5000:] = PAD
    sp = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    pb, shift, slr = P.plan_geometry_counts(lo, hi)
    geom = X.RadixGeom(chunk_rows=4096, part_bits=pb, lo=lo, hi=hi,
                       shift=shift)
    r_part = X.partition_pass_kv(X._chunk_pad(rk, 4096 * 128, cuda),
                                 X._chunk_pad(rp, 4096 * 128, cuda), geom)
    tables = P.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr,
                           r_part[2])
    s_part = X.partition_pass_kv(torch.from_numpy(sk).to(cuda),
                                 torch.from_numpy(sp).to(cuda), geom)
    sentinel = 0x5A5A5A5A
    blocks = [torch.full_like(s_part[0], sentinel) for _ in range(4)]
    torch.cuda.synchronize()
    del blocks
    args = (*tables, s_part[0], s_part[1], lo, shift, pb, slr)
    got = P.materialize_pairs(*args, s_part[2])
    want = P.materialize_pairs_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not any(bool((g == sentinel).any()) for g in got[:3])
    assert int(got[3]) == int(np.isin(sk, rk).sum()) > 0
    # the bucket runs end where the pad run starts: under 2 % of S
    assert int(s_part[2].view(3, -1)[:, 1 << pb].sum()) < 0.02 * n


def test_probe_and_materialize_need_starts(cuda):
    pad = np.full(3 * 1024, PAD, np.int32)
    pb, shift, slr = P.plan_geometry_counts(1, 5000, 3)
    geom = X.RadixGeom(chunk_rows=8, part_bits=pb, lo=1, hi=5000, shift=shift)
    part = X.partition_pass_kv(X._chunk_pad(pad, 1024, cuda),
                               X._chunk_pad(pad, 1024, cuda), geom)
    tables = P.table_build(part[0], part[1], 1, 5000, pb, shift, slr, part[2])
    args = (*tables, part[0], part[1], 1, shift, pb, slr)
    with pytest.raises(ValueError, match="starts"):
        P.probe_count_sums(*args)
    with pytest.raises(ValueError, match="starts"):
        P.materialize_pairs(*args)
    with pytest.raises(ValueError, match="starts"):
        P.probe_count_sums(*args, part[2][:-1])


def _hash_keys(rng, n, pad_frac=0.07):
    k = rng.integers(-2**31 + 1, 2**31, n, dtype=np.int64)
    k[rng.random(n) < pad_frac] = PAD
    return torch.from_numpy(k.astype(np.int32))


@pytest.mark.parametrize("chunk_rows,nchunks", [(8, 1), (40, 3), (4096, 2)])
@pytest.mark.parametrize("part_bits,hash_bits", [(0, 7), (3, 9), (10, 21),
                                                 (13, 13)])
def test_hash_partition_kernel_matches_twin(cuda, chunk_rows, nchunks,
                                            part_bits, hash_bits):
    rng = np.random.default_rng(part_bits * 3 + chunk_rows)
    keys = _hash_keys(rng, nchunks * chunk_rows * 128).to(cuda)
    keys[:chunk_rows * 128 // 2] = PAD            # half a chunk of PAD
    geom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits,
                       hash_seed=0x9E3779B9, hash_bits=hash_bits)
    got = X.partition_pass(keys, geom)
    want = X.partition_pass_plain(keys, geom)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _pass2_case(cuda, mode, chunk_rows, nchunks, b1, b2, keys):
    if mode == "hash":
        kw = dict(hash_seed=42, hash_bits=b1 + b2 + 4)
        p2kw = kw
    else:
        shift = 24 - b1 - b2
        kw = dict(lo=1, hi=16_000_000, shift=shift + b2)
        p2kw = dict(lo=1, hi=16_000_000, shift1=shift + b2, shift2=shift)
    s1, st1 = X.partition_pass(keys.to(cuda),
                               X.RadixGeom(chunk_rows=chunk_rows,
                                           part_bits=b1, **kw))
    geom = M.plan_pass2(s1, st1, b1, b2, chunk_rows, 4096, **p2kw)
    if geom is None:             # a run filling a chunk: the planner's None
        geom = M.Pass2Geom(b1=b1, b2=b2, chunk_rows=chunk_rows,
                           nchunks=nchunks, c1_rows=chunk_rows,
                           cap_rows=nchunks * chunk_rows,
                           cat2_rows=((1 << b2) + 1 + 127) // 128 + 7 & ~7,
                           **{"lo": 0, "hi": 0, "shift1": 0, "shift2": 0,
                              **p2kw})
    got = M.pass2_partition(s1, st1, geom)
    want = M.pass2_partition_plain(s1, st1, geom)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    return got


def _pass2_keys(rng, mode, n):
    if mode == "hash":
        return _hash_keys(rng, n)
    k = rng.integers(1, 16_000_001, n)
    u = rng.random(n)
    k[u < 0.2] = rng.integers(16_000_001, 1 << 24, int((u < 0.2).sum()))
    k[u < 0.05] = rng.integers(-2**31 + 1, 1, int((u < 0.05).sum()))
    k[u > 0.95] = PAD
    return torch.from_numpy(k.astype(np.int32))


@pytest.mark.parametrize("mode", ["range", "hash"])
@pytest.mark.parametrize("chunk_rows,nchunks,b1,b2", [
    (8, 1, 1, 1), (64, 3, 3, 3), (4096, 2, 6, 6), (4096, 2, 10, 3),
    (256, 2, 2, 10),
    # spans of several chunks whose windows (72 rows) do not divide into
    # 4,096-key tiles, a last span of one chunk; b2 = 10 over 5 chunks;
    # b2 = 2; runs of 0 and 1 keys (1,024-key chunks, 1,024 buckets)
    (4096, 9, 6, 6), (1024, 5, 2, 10), (512, 3, 4, 2), (8, 40, 10, 3)])
def test_pass2_kernel_matches_twin(cuda, mode, chunk_rows, nchunks, b1, b2):
    rng = np.random.default_rng(b1 * 16 + b2 + chunk_rows)
    keys = _pass2_keys(rng, mode, nchunks * chunk_rows * 128)
    _pass2_case(cuda, mode, chunk_rows, nchunks, b1, b2, keys)


@pytest.mark.parametrize("mode", ["range", "hash"])
@pytest.mark.parametrize("b1,b2", [(2, 3), (3, 10)])
def test_pass2_kernel_truncates_at_the_region_capacity(cuda, mode, b1, b2):
    """A hand-made geometry whose regions hold fewer rows than their live
    keys: each region keeps its first cap_elems keys in sub-category order,
    starts2 still counts every live key."""
    chunk_rows, nchunks = 64, 6
    rng = np.random.default_rng(b1 + b2)
    keys = _pass2_keys(rng, mode, nchunks * chunk_rows * 128).to(cuda)
    if mode == "hash":
        kw = p2kw = dict(hash_seed=42, hash_bits=b1 + b2 + 4)
    else:
        shift = 24 - b1 - b2
        kw = dict(lo=1, hi=16_000_000, shift=shift + b2)
        p2kw = dict(lo=1, hi=16_000_000, shift1=shift + b2, shift2=shift)
    s1, st1 = X.partition_pass(keys, X.RadixGeom(chunk_rows=chunk_rows,
                                                 part_bits=b1, **kw))
    planned = M.plan_pass2(s1, st1, b1, b2, chunk_rows, None, **p2kw)
    live = nchunks * chunk_rows * 128 // (1 << b1)
    geom = M.Pass2Geom(**{**planned.__dict__, "cap_rows": live // 3 // 128})
    got = M.pass2_partition(s1, st1, geom)
    want = M.pass2_partition_plain(s1, st1, geom)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    F2 = 1 << b2
    assert int(got[1].view(1 << b1, -1)[:, F2].min()) > geom.cap_rows * 128


def test_pass2_kernel_all_pad_over_many_spans(cuda):
    """An all-PAD stream over more chunks than a span takes: every region
    PAD, starts2 0 up to F2, both modes."""
    n = 70 * 8 * 128
    for mode in ("range", "hash"):
        out, starts2 = _pass2_case(cuda, mode, 8, 70, 4, 3,
                                   torch.full((n,), PAD, dtype=torch.int32))
        assert (out == PAD).all()
        assert (starts2.view(16, -1)[:, :9] == 0).all()


@pytest.mark.parametrize("mode", ["range", "hash"])
def test_pass2_kernel_all_pad_and_empty_buckets(cuda, mode):
    """All PAD: every region PAD, starts2 0 up to F2; keys of one pass-1
    bucket only (range mode: [1, 2^18]): the other regions empty."""
    n = 2 * 64 * 128
    out, starts2 = _pass2_case(cuda, mode, 64, 2, 3, 2,
                               torch.full((n,), PAD, dtype=torch.int32))
    assert (out == PAD).all()
    assert (starts2.view(8, -1)[:, :5] == 0).all()
    rng = np.random.default_rng(3)
    keys = torch.from_numpy(rng.integers(1, 1 << 18, n).astype(np.int32)) \
        if mode == "range" else _hash_keys(rng, n)
    _pass2_case(cuda, mode, 64, 2, 3, 2, keys)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
@pytest.mark.parametrize("B,m", [(32, 1 << 15), (512, 1 << 22),
                                 (1 << 17, 1 << 24)])
def test_bloom_probe_kernel_matches_twin(cuda, k, B, m):
    rng = np.random.default_rng(k + B)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=m, k=k, B=B, seed=7)
    add = _hash_keys(rng, 20_000, 0.0).to(cuda)
    words = bloom.build_bitmap(add, args)
    s = torch.cat([add[:5000], _hash_keys(rng, 3 * 4096).to(cuda)])
    out = torch.full((s.numel() + 256,), 3, dtype=torch.int32, device=cuda)
    got, n = BP.bloom_probe_prune(words, s, args, out=out)
    want, wn = BP.bloom_probe_prune_plain(words, s, args)
    torch.cuda.synchronize()
    assert torch.equal(got[:s.numel()], want) and int(n) == int(wn)
    assert (got[s.numel():] == 3).all()
    assert int(n) >= 5000 - int((add[:5000] == PAD).sum())


def test_bloom_probe_kernel_empty_filter_and_all_pad(cuda):
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 16, k=3, B=512)
    empty = torch.zeros(args.m // 32, dtype=torch.int32, device=cuda)
    full = torch.full_like(empty, -1)
    keys = _hash_keys(np.random.default_rng(1), 8192).to(cuda)
    got, n = BP.bloom_probe_prune(empty, keys, args)
    assert int(n) == 0 and (got == PAD).all()
    got, n = BP.bloom_probe_prune(full, keys, args)
    assert int(n) == int((keys != PAD).sum()) and torch.equal(got, keys)
    pads = torch.full((4096,), PAD, dtype=torch.int32, device=cuda)
    got, n = BP.bloom_probe_prune(full, pads, args)
    assert int(n) == 0 and (got == PAD).all()


def _build_keys(rng):
    """100,003 keys for a filter (a 3-key tail): negatives, PAD, one key
    1,000 times and 30,000 repeats of others."""
    keys = _hash_keys(rng, 70_003)
    keys[:1000] = keys[1000]
    return torch.cat([keys, keys[rng.integers(0, 70_003, 30_000)]])


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("variant,B,m", [
    ("basic", 512, 1 << 10), ("basic", 512, 1 << 24),
    ("basic", 512, 1 << 30), ("blocked", 32, 1 << 10),
    ("blocked", 512, 1 << 22), ("blocked", 512, 1 << 30),
    ("blocked", 1 << 17, 1 << 17), ("blocked", 1 << 17, 1 << 26),
    ("blocked", 1 << 28, 1 << 30)])
def test_bloom_build_kernel_matches_twin(cuda, k, variant, B, m):
    """Both variants, k = 1 to 8, B = 32 to 2^28, m = 2^10 to 2^30 (one
    launch, 8 sections, and 4 sections of one block each): the kernel's
    words equal the plain build's bit for bit, over duplicates,
    negatives and PAD (_build_keys), and over the same keys less the first
    (a view that starts between 16-byte boundaries)."""
    rng = np.random.default_rng(k * 131 + m.bit_length() + B)
    args = BloomArgs(variant=BloomVariant(variant), m=m, k=k, B=B, seed=7)
    keys = _build_keys(rng).to(cuda)
    for view in (keys, keys[1:]):
        got = bloom.build_bitmap(view, args)
        want = bloom.build_bitmap_plain(view, args)
        torch.cuda.synchronize()
        assert got.shape == (m // 32,) and torch.equal(got, want)


def test_bloom_build_kernel_at_the_flagship_filter(cuda):
    """m = 2^30, B = 512, k = 1 over 16M keys: the plain build's words and
    the benchmark reference's positions (joinbench/filterhash.py), set by
    an index_add of distinct powers of two."""
    from joinbench import filterhash
    rng = np.random.default_rng(5)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 30, k=1, B=512)
    keys = torch.from_numpy(rng.integers(-2**31, 2**31, 1 << 24,
                                         dtype=np.int64).astype(np.int32))
    keys = keys.to(cuda)
    got = bloom.build_bitmap(keys, args)
    assert torch.equal(got, bloom.build_bitmap_plain(keys, args))
    pos = torch.unique(filterhash.positions(keys, {
        "variant": "blocked", "m": args.m, "k": 1, "B": 512,
        "seed": args.seed})[0])
    want = torch.zeros(args.m // 32, dtype=torch.int64, device=cuda)
    want.index_add_(0, pos >> 5, torch.ones_like(pos) << (pos & 31))
    assert torch.equal(got.long() & 0xFFFFFFFF, want)


def test_bloom_build_kernel_edges_and_launches(cuda):
    """Empty, 1 to 7 keys at each of the four 4-byte offsets (head and tail
    only), all PAD, against the plain build and the reference filter
    (native.ref_bloom); one launch a call, an empty R's included; int64
    and non-contiguous keys on the card are refused, unlaunched."""
    from hwbloomradixjoin_tpu_torch.data import native
    rng = np.random.default_rng(17)
    base = _hash_keys(rng, 64).to(cuda)
    _build.reset_launches()
    calls = 0
    for variant in ("basic", "blocked"):
        args = BloomArgs(variant=BloomVariant(variant), m=1 << 12, k=3,
                         B=64)
        empty = bloom.build_bitmap(base[:0], args)
        assert empty.shape == (128,) and not empty.any()
        calls += 1
        cases = [base[off:off + n] for off in range(4) for n in range(1, 8)]
        cases.append(torch.full((9,), PAD, dtype=torch.int32, device=cuda))
        for keys in cases:
            got = bloom.build_bitmap(keys, args)
            calls += 1
            assert torch.equal(got, bloom.build_bitmap_plain(keys, args))
            _, ref = native.ref_bloom(variant, args.m, 3, 64, args.seed,
                                      keys.cpu().numpy(), keys[:1].cpu()
                                      .numpy(), want_bitmap=True)
            assert np.array_equal(got.cpu().numpy().view(np.uint8), ref)
    assert _build.LAUNCHES["bloom_build"] == calls
    with pytest.raises(ValueError):
        bloom.build_bitmap(base.long(), args)
    with pytest.raises(ValueError):
        bloom.build_bitmap(base[::2], args)
    assert _build.LAUNCHES["bloom_build"] == calls


def test_bloom_prune_plan_on_card_equals_plan_on_cpu(cuda):
    """One and two hash passes (the flagship's 13-bit geometry at m = 2^30
    goes two-pass): the same pruned buffer and survivor count."""
    rng = np.random.default_rng(31)
    rk = rng.integers(1, 1 << 30, 200_000).astype(np.int32)
    sk = np.concatenate([rk[:50_000],
                         rng.integers(1, 1 << 30, 600_000).astype(np.int32)])
    for m in (1 << 22, 1 << 30):
        args = BloomArgs(variant=BloomVariant.BLOCKED, m=m, k=1, B=512)
        on_card = BP.plan_bloom_prune(rk, sk, args, device=cuda,
                                      chunk_rows=512)
        on_cpu = BP.plan_bloom_prune(rk, sk, args, device="cpu",
                                     chunk_rows=512)
        assert (on_card.pass2 is None) == (m == 1 << 22)
        assert on_card.s_after == on_cpu.s_after
        assert torch.equal(on_card.out.cpu(), on_cpu.out)


@pytest.mark.parametrize("case", ["past_2048_chunks", "hot_key"])
def test_bloom_prune_past_the_tpu_limits_on_card(cuda, case):
    """The flagship's 13-bit geometry (m = 2^30) where the JAX planner
    declines its Pallas prune: 2,049 chunks (past its 2,048-chunk cap) run
    the hash partition, pass 2 and the probe kernels; one hot key (a run
    filling a chunk, a skewed S) probes pass 1's order.  Survivors and
    count equal the plain prune's on the card."""
    from hwbloomradixjoin_tpu_torch.models import bloom_join
    rng = np.random.default_rng(41)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 30, k=1, B=512)
    chunk_rows = 8 if case == "past_2048_chunks" else 512
    n = 2049 * chunk_rows * 128 if case == "past_2048_chunks" else 700_000
    sk = rng.integers(-2**31 + 1, 2**31, n, dtype=np.int64).astype(np.int32)
    if case == "hot_key":
        sk[:400_000] = sk[-1]
    rk = np.concatenate([rng.choice(sk, 100_000),
                         rng.integers(-2**31 + 1, 2**31, 100_000,
                                      dtype=np.int64).astype(np.int32)])
    _build.reset_launches()
    plan = BP.plan_bloom_prune(rk, sk, args, device=cuda,
                               chunk_rows=chunk_rows)
    ran = dict(_build.LAUNCHES)
    assert ran["partition_hash"] > 0 and ran["bloom_probe"] > 0
    if case == "past_2048_chunks":
        assert plan.pass2 is not None and plan.pass2.nchunks == 2049
        assert ran["pass2_partition_hash"] > 0
    else:
        assert plan.pass2 is None and ran["pass2_partition_hash"] == 0
    r, s = torch.from_numpy(rk).to(cuda), torch.from_numpy(sk).to(cuda)
    mask, n_plain = bloom_join.bloom_prune(r, s, args)
    out = plan.out[plan.out != PAD]
    assert plan.s_after == int(n_plain) == out.numel()
    assert torch.equal(torch.sort(out).values, torch.sort(s[mask]).values)



@pytest.mark.parametrize("n", [1, 5, 127, 4096, 1_000_003])
def test_dense_kernel_matches_twin(cuda, n):
    """Odd lengths (the scalar tail), payloads at +-2^31 so the sum wraps,
    keys at lo - 1, hi + 1, negative and PAD."""
    rng = np.random.default_rng(n)
    keys = _keys(rng, n, 7, 90_000)
    keys[::11] = 6
    keys[::13] = 90_001
    pays = torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                            .astype(np.int32))
    pays[::3] = 2**31 - 1
    k, p = keys.to(cuda), pays.to(cuda)
    got = D.dense_count_join(k, p, 7, 90_000)
    want = D.dense_count_join_plain(k, p, 7, 90_000)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert got.tolist() == D.dense_count_join_plain(keys, pays, 7,
                                                    90_000).tolist()


def test_dense_kernel_all_pad_and_empty(cuda):
    pads = torch.full((4099,), PAD, dtype=torch.int32, device=cuda)
    assert D.dense_count_join(pads, pads, 1, 100).tolist() == [0, 0]
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    assert D.dense_count_join(empty, empty, 1, 100).tolist() == [0, 0]


def _materialize_case(cuda, rk, rp, sk, sp, lo, hi, bits=None,
                      chunk_rows=8):
    """Tables from R, images from S on the card; equal to the twins'."""
    pb, shift, slr = P.plan_geometry_counts(lo, hi, bits)
    chunk = chunk_rows * 128
    geom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=pb, lo=lo, hi=hi,
                       shift=shift)
    r_part = X.partition_pass_kv(X._chunk_pad(rk, chunk, cuda),
                                 X._chunk_pad(rp, chunk, cuda), geom)
    tables = P.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr,
                           r_part[2])
    s_part = X.partition_pass_kv(X._chunk_pad(sk, chunk, cuda),
                                 X._chunk_pad(sp, chunk, cuda), geom)
    args = (*tables, s_part[0], s_part[1], lo, shift, pb, slr)
    got = P.materialize_pairs(*args, s_part[2])
    want = P.materialize_pairs_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("lo,hi,bits", [(1, 299, None), (1, 60000, 4),
                                        (-(1 << 20), (1 << 20) - 1, 6),
                                        (1, 16_000_000, None)])
def test_materialize_kernel_matches_twin(cuda, lo, hi, bits):
    rng = np.random.default_rng(abs(lo) % 991 + hi % 991)
    span = hi - lo + 1
    rk = (rng.choice(span, min(span, 20_000), replace=False) + lo) \
        .astype(np.int32)
    rp = rng.integers(-2**31, 2**31, len(rk), dtype=np.int64).astype(np.int32)
    rp[::5] = PAD                        # a payload equal to PAD is a pair
    sk = np.concatenate([rng.choice(rk, 7000),
                         _keys(rng, 9001, lo, hi).numpy()])
    sp = rng.integers(-2**31, 2**31, len(sk), dtype=np.int64).astype(np.int32)
    out_r, out_s, out_k, n = _materialize_case(cuda, rk, rp, sk, sp, lo, hi,
                                               bits)
    keep = out_k != PAD
    rmap = dict(zip(rk.tolist(), rp.tolist()))
    want = sorted((rmap[k], p) for k, p in zip(sk.tolist(), sp.tolist())
                  if k in rmap)
    got = sorted(zip(out_r[keep].tolist(), out_s[keep].tolist()))
    assert int(n) == len(want) and got == want
    assert (out_r[keep] == PAD).any()


def test_materialize_kernel_all_pad_and_empty_buckets(cuda):
    pad = np.full(3 * 1024, PAD, np.int32)
    out = _materialize_case(cuda, pad, pad, pad, pad, 1, 5000, 3)
    assert int(out[3]) == 0 and all((o == PAD).all() for o in out[:3])
    rk = np.arange(1, 100, dtype=np.int32)           # bucket 0 of 8 only
    sk = np.arange(1, 5000, dtype=np.int32)
    out = _materialize_case(cuda, rk, rk * 3, sk, -sk, 1, 5000, 3)
    assert int(out[3]) == 99


def _gathered_case(cuda, rk, sk, geom):
    parts = []
    for keys in (rk, sk):
        parts += X.partition_pass(X._chunk_pad(keys, geom.chunk_rows * 128,
                                               cuda), geom)
    got = X.gathered_probe_count(*parts, geom)
    want = X.gathered_probe_count_plain(*parts, geom)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    return got.tolist()


@pytest.mark.parametrize("chunk_rows,part_bits", [(8, 0), (40, 5), (1024, 12),
                                                  (64, 13)])
def test_gathered_probe_kernel_matches_twin(cuda, chunk_rows, part_bits):
    """Duplicates on both sides, negative keys, PAD; the JAX default
    geometry (1024 rows, 12 bits) among others."""
    from hwbloomradixjoin_tpu_torch.data import native
    rng = np.random.default_rng(chunk_rows + part_bits)
    rk = rng.integers(-40_000, 40_000, 30_001).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 20_000),
                         _keys(rng, 70_001, -50_000, 50_000).numpy()])
    geom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=part_bits)
    count, ovf = _gathered_case(cuda, rk, sk, geom)
    assert ovf == 0
    assert count == native.ref_join(rk, np.zeros_like(rk), sk,
                                    np.zeros_like(sk))[0]


def test_gathered_probe_kernel_all_pad_and_empty_buckets(cuda):
    geom = X.RadixGeom(chunk_rows=8, part_bits=4)
    pads = np.full(3000, PAD, np.int32)
    assert _gathered_case(cuda, pads, pads, geom) == [0, 0]
    rk = np.arange(0, 64_000, 16, dtype=np.int32)     # bucket 0 only
    sk = np.arange(0, 70_000, dtype=np.int32)
    assert _gathered_case(cuda, rk, sk, geom) == [4000, 0]
    assert _gathered_case(cuda, rk, pads, geom) == [0, 0]


@pytest.mark.parametrize("extra", [0, 1, -1])
def test_gathered_probe_kernel_at_the_capacity(cuda, extra):
    """Bucket 0 holds exactly R_CAP R keys (probed) or one more (overflow:
    not probed, the flag set); the other buckets are counted either way."""
    geom = X.RadixGeom()
    hot = (np.arange(X.R_CAP + extra, dtype=np.int64) % 20_000 * 4096) \
        .astype(np.int32)
    cold = np.arange(1, 300_000, dtype=np.int32)
    cold = cold[cold % 4096 != 0]
    rk = np.concatenate([hot, cold])
    sk = np.concatenate([hot[:1000], cold[::2]])
    count, ovf = _gathered_case(cuda, rk, sk, geom)
    mult = np.bincount(hot % (20_000 * 4096) // 4096)
    hot_pairs = int(mult[hot[:1000] // 4096].sum())
    over = extra > 0
    assert ovf == over
    assert count == len(cold[::2]) + (0 if over else hot_pairs)
    assert X.radix_join_count(rk, sk, device=cuda) == \
        ((0, True) if over else (count, False))


def _ref_count(rk, sk):
    from hwbloomradixjoin_tpu_torch.data import native
    return native.ref_join(rk, np.zeros_like(rk), sk, np.zeros_like(sk))[0]


def test_gathered_probe_kernel_buckets_of_one_key(cuda):
    """The largest bucket holds one R key (the smallest class), S repeats
    them and misses."""
    geom = X.RadixGeom()
    rk = np.arange(-2000, 2000, dtype=np.int32) * 4099
    sk = np.concatenate([np.repeat(rk[::3], 3), rk + 1])
    count, ovf = _gathered_case(cuda, rk, sk, geom)
    assert (count, ovf) == (3 * len(rk[::3]), 0)


def test_gathered_probe_kernel_every_capacity_class(cuda):
    """One hot bucket among small ones: buckets of 30,000 (the device-memory
    table), 12,000, 3,000 and about 100 R keys, duplicates on both sides,
    all in one call."""
    geom = X.RadixGeom()
    rng = np.random.default_rng(7)
    parts = [rng.integers(0, 1 << 19, n) * 4096 + b
             for b, n in ((0, 30_000), (1, 12_000), (2, 3_000))]
    small = rng.integers(0, 1 << 19, 400_000) * 4096 \
        + rng.integers(3, 4096, 400_000)
    rk = np.concatenate(parts + [small]).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 300_000),
                         rng.integers(-2**31 + 1, 2**31, 100_000)])
    sk = sk.astype(np.int32)
    count, ovf = _gathered_case(cuda, rk, sk, geom)
    assert ovf == 0 and count == _ref_count(rk, sk)
    sizes = np.bincount(rk & 4095, minlength=4096)
    assert sizes.max() == 30_000 and sizes[3:].max() < 1433


def test_gathered_probe_kernel_runs_of_zero_and_one_key(cuda):
    """1,024-key chunks over 4,096 buckets: most runs hold 0 or 1 keys."""
    geom = X.RadixGeom(chunk_rows=8, part_bits=12)
    rng = np.random.default_rng(8)
    rk = rng.integers(-10**6, 10**6, 6_000).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 5_000),
                         rng.integers(-10**6, 10**6, 5_000)]).astype(np.int32)
    count, ovf = _gathered_case(cuda, rk, sk, geom)
    assert ovf == 0 and count == _ref_count(rk, sk)


def test_gathered_probe_kernel_at_the_radix_count_geometry(cuda):
    """radix_join_count's geometry (1,024-row chunks, 12 bits) at 2M R keys
    (about 4 copies of each key) and 8M S keys, against ref_join."""
    rng = np.random.default_rng(9)
    rk = rng.integers(0, 500_000, 2_000_000).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, 6_000_000),
                         rng.integers(-2**31 + 1, 2**31, 2_000_000)])
    sk = sk.astype(np.int32)
    count, ovf = _gathered_case(cuda, rk, sk, X.RadixGeom())
    assert ovf == 0 and count == _ref_count(rk, sk)


def test_default_config_takes_the_dense_tier(cuda):
    """run_join("PRO") with EngineConfig() over the generator's dense PK
    takes the dense tier on the card (it raised NotImplementedError before
    the tier was ported): the exact count and the ht tier's S checksum."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.models import run_join
    from hwbloomradixjoin_tpu_torch.types import Relation
    p = G.WorkloadParams(r_size=200_000, s_size=3_000_000, nthreads=4,
                         selectivity=0.3)
    rk, rp, sk, sp = G.build_workload(p)
    R = Relation.from_numpy(rk, rp, device=cuda, stats=G.r_key_stats(p))
    S = Relation.from_numpy(sk, sp, device=cuda)
    _build.reset_launches()
    res, st, sums = run_join("PRO", R, S)
    assert _build.LAUNCHES["dense_count"] > 0
    assert st.tier == "dense"
    assert res.count() == G.expected_uniform_match_count(3_000_000, 0.3)
    _, ref_st, ref_sums = run_join("PRO", R, S, EngineConfig(
        radix=RadixConfig(use_kernels=False), allow_dense=False))
    assert ref_st.tier == "ht" and sums == (0, ref_sums[1])


def test_materialize_on_card_keeps_pad_payloads(cuda):
    """run_join(materialize=True) on the card: R payloads equal to -2^31
    stay pairs (compaction masks on the key image), the pairs equal the
    portable tier's, and the kernels launched."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig
    from hwbloomradixjoin_tpu_torch.models import run_join
    from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation
    rng = np.random.default_rng(77)
    rk = rng.permutation(np.arange(1, 50_001)).astype(np.int32)
    rp = np.full(len(rk), PAD, np.int32)
    rp[::2] = np.arange(len(rk[::2]), dtype=np.int32)
    sk = rng.integers(-10, 120_000, 400_000).astype(np.int32)
    sp = np.arange(len(sk), dtype=np.int32)
    R = Relation.from_numpy(rk, rp, device=cuda,
                            stats=KeyStats(1, 50_000, is_unique=True))
    S = Relation.from_numpy(sk, sp, device=cuda)
    _build.reset_launches()
    res, st, _ = run_join("PRO", R, S, EngineConfig(materialize=True))
    ran = dict(_build.LAUNCHES)
    assert st.tier == "cuda_materialize"
    assert all(ran[k] > 0 for k in ("partition_kv", "table_build",
                                    "materialize"))
    ref, ref_st, _ = run_join("PRO", R, S, EngineConfig(
        radix=RadixConfig(use_kernels=False), materialize=True))
    assert ref_st.tier == "materialize"
    want = int(((sk >= 1) & (sk <= 50_000)).sum())
    assert res.count() == ref.count() == want == res.r_payload.numel()
    assert int((res.r_payload == PAD).sum()) > want // 3

    def pairs(r):
        return torch.sort((r.s_payload.long() << 32)
                          | (r.r_payload.long() & 0xFFFFFFFF)).values
    assert torch.equal(pairs(res), pairs(ref))


# Splits forced on the staged probes (ops/run_split.py): the planner's own;
# 3 buckets a CTA (a partial last range), a segment a CTA; 1 bucket, every
# segment in one span, a warp a run; 4 buckets, spans of 2, one lane a run.
# Regions keep one segment a CTA.  The bitmap probe's size rules (its flat
# class for small live slices and a small S) are lifted, so these small
# inputs take the staged class.
PROBE_SPLITS = {"planned": {}, "nb3": dict(nb=3, span=1),
                "all_segments": dict(nb=1, span=1 << 30, group=32),
                "lane_runs": dict(nb=4, span=2, group=1)}


def _force_split(monkeypatch, name):
    monkeypatch.setattr(B, "PROBE_MIN_SLICE", 0)
    monkeypatch.setattr(B, "PROBE_MIN_KEYS_A_WORD", 0)
    planned = run_split.plan_split
    force = PROBE_SPLITS[name]

    def forced(*args, **kwargs):
        split = planned(*args, **kwargs)
        if split is None or not force:
            return split
        return dataclasses.replace(
            split, nb=min(force["nb"], split.seg_buckets),
            span=1 if split.regions else min(force["span"], split.nseg),
            group=force.get("group", split.group))
    monkeypatch.setattr(run_split, "plan_split", forced)


@pytest.mark.parametrize("split", list(PROBE_SPLITS))
@pytest.mark.parametrize("chunk_rows,nchunks,bits,lo,hi", [
    (8, 5, 10, 1, 5_000_000),           # 1,024 buckets: runs of 0-1 keys
    (64, 4, 6, 1, 5_000_000),           # shift 17: keys above hi in bucket 38
    (16, 3, 4, -(1 << 20), (1 << 20) - 1)])
def test_bitmap_probe_walks_every_split(cuda, monkeypatch, split, chunk_rows,
                                        nchunks, bits, lo, hi):
    """The staged bitmap probe over partition chunks against the twin and
    numpy: keys of R, below lo, above hi inside the last bucket and past it,
    PAD, an all-PAD chunk and a chunk of one bucket; the built, an empty and
    a full bitmap (the full one counts the keys above hi inside the last
    bucket, from the pad runs)."""
    _force_split(monkeypatch, split)
    rng = np.random.default_rng(bits + chunk_rows)
    pb, shift, slr = B.plan_geometry(lo, hi, bits)
    rk = (rng.choice(hi - lo + 1, 60_000, replace=False) + lo).astype(np.int32)
    chunk = chunk_rows * 128
    n = nchunks * chunk
    sk = _keys(rng, n, lo, hi).numpy()
    sk[:n // 3] = rng.choice(rk, n // 3)
    top = lo + ((1 << pb) << shift) - 1                 # the last bucket's end
    sk[n // 3:n // 3 + 300] = rng.integers(hi + 1, max(top, hi + 1) + 1, 300)
    rng.shuffle(sk)
    sk[chunk:2 * chunk] = PAD                           # an all-PAD chunk
    sk[2 * chunk:3 * chunk] = rng.integers(lo, lo + (1 << shift), chunk)
    s_in = torch.from_numpy(sk).to(cuda)
    part, starts = X.partition_pass(s_in, X.RadixGeom(
        chunk_rows=chunk_rows, part_bits=pb, lo=lo, hi=hi, shift=shift))
    assert B.probe_split(part, starts, shift, pb) is not None
    built = B.build_bitmap(torch.from_numpy(rk).to(cuda), lo, hi, pb, shift,
                           slr)
    for bm in (built, torch.zeros_like(built), torch.full_like(built, -1)):
        got = B.bitmap_probe_count(bm, part, lo, shift, pb, slr, starts)
        want = B.bitmap_probe_count_plain(bm, part, lo, shift, pb, slr)
        torch.cuda.synchronize()
        assert int(got) == int(want)
    assert int(B.bitmap_probe_count(built, part, lo, shift, pb, slr,
                                    starts)) == int(np.isin(sk, rk).sum())


@pytest.mark.parametrize("split", ["planned", "nb3", "lane_runs"])
@pytest.mark.parametrize("chunk_rows,nchunks,b1,b2", [(64, 5, 3, 3),
                                                      (8, 40, 6, 2)])
def test_bitmap_probe_walks_pass2_regions(cuda, monkeypatch, split,
                                          chunk_rows, nchunks, b1, b2):
    """The staged bitmap probe over range-mode pass-2 regions (bucket j of
    region r is r * 2^b2 + j; each region's PAD tail tested from device
    memory) against the twin, for the built, an empty and a full bitmap."""
    _force_split(monkeypatch, split)
    rng = np.random.default_rng(b1 * 8 + b2)
    keys = _pass2_keys(rng, "range", nchunks * chunk_rows * 128)
    regions, starts2 = _pass2_case(cuda, "range", chunk_rows, nchunks, b1,
                                   b2, keys)
    pb, shift = b1 + b2, 24 - b1 - b2
    slr = max(1 << (shift - 12), 8)
    split_ = B.probe_split(regions, starts2, shift, pb, b2)
    assert split_ is not None and split_.regions
    live = keys[(keys >= 1) & (keys <= 16_000_000)]
    built = B.build_bitmap(live[::3].to(cuda), 1, 16_000_000, pb, shift, slr)
    for bm in (built, torch.zeros_like(built), torch.full_like(built, -1)):
        got = B.bitmap_probe_count(bm, regions, 1, shift, pb, slr, starts2,
                                   seg_bits=b2)
        want = B.bitmap_probe_count_plain(bm, regions, 1, shift, pb, slr)
        torch.cuda.synchronize()
        assert int(got) == int(want)


@pytest.mark.parametrize("bits,nchunks,why", [
    (2, 3, "512 KiB slices, past the staging budget"),
    (12, 40, "512-byte live slices"),
    (6, 3, "fewer than 8 keys a bitmap word")])
def test_bitmap_probe_flat_class_and_needs_starts(cuda, bits, nchunks, why):
    """Each geometry of the flat class over 2^24 keys, against the twin and
    numpy; without starts, or with starts of the wrong size, the probe
    raises on the card."""
    rng = np.random.default_rng(23 + bits)
    lo, hi = 1, 1 << 24
    pb, shift, slr = B.plan_geometry(lo, hi, bits)
    rk = (rng.choice(hi, 100_000, replace=False) + lo).astype(np.int32)
    sk = _keys(rng, nchunks * 4096 * 128, lo, hi)
    sk[:5000] = torch.from_numpy(rng.choice(rk, 5000))
    part, starts = X.partition_pass(sk.to(cuda), X.RadixGeom(
        chunk_rows=4096, part_bits=pb, lo=lo, hi=hi, shift=shift))
    assert B.probe_split(part, starts, shift, pb) is None, why
    bm = B.build_bitmap(torch.from_numpy(rk).to(cuda), lo, hi, pb, shift, slr)
    for b in (bm, torch.full_like(bm, -1)):
        got = B.bitmap_probe_count(b, part, lo, shift, pb, slr, starts)
        assert int(got) == int(B.bitmap_probe_count_plain(b, part, lo, shift,
                                                          pb, slr))
    assert int(B.bitmap_probe_count(bm, part, lo, shift, pb, slr, starts)) \
        == int(np.isin(sk.numpy(), rk).sum())
    with pytest.raises(ValueError, match="starts"):
        B.bitmap_probe_count(bm, part, lo, shift, pb, slr)
    with pytest.raises(ValueError, match="starts"):
        B.bitmap_probe_count(bm, part, lo, shift, pb, slr, starts[:-128])


# Splits forced on the staged build (ops/run_split.py plan_share_split):
# the planner's own; one CTA a range; 3 CTAs over 4-bucket ranges; 8 CTAs a
# bucket; 64 buckets a range (as many as 128 KiB holds) over 8 CTAs.
BUILD_SPLITS = {"planned": {}, "share1": dict(nb=1, share=1),
                "share3_nb4": dict(nb=4, share=3),
                "share8_nb1": dict(nb=1, share=8),
                "one_range": dict(nb=64, share=8)}


def _force_build_split(monkeypatch, name):
    planned = run_split.plan_share_split
    force = BUILD_SPLITS[name]

    def forced(runs, seg_bits, slice_bytes, *args):
        split = planned(runs, seg_bits, slice_bytes, *args)
        if split is None or not force:
            return split
        nb = min(force["nb"], split.seg_buckets,
                 max(1, B.BUILD_MAX_STAGE // slice_bytes))
        return dataclasses.replace(split, nb=nb, share=force["share"])
    monkeypatch.setattr(run_split, "plan_share_split", forced)


def _build_case(cuda, rk, lo, hi, bits, chunk_rows, pad_cat=None,
                geom_lo=None, geom_hi=None):
    """R (numpy) chunk-padded and partitioned at the build geometry of
    [lo, hi] (at `bits` partition bits); pad_cat None as the plans choose
    it.  geom_lo / geom_hi partition at another range of the same fan-out.
    Returns the partition, its starts and the geometry."""
    pb, shift, slr = B.plan_geometry(lo, hi, bits)
    rb, rshift, rslr = B.plan_build_geometry(lo, hi, pb, shift, slr)
    chunk = chunk_rows * 128
    geom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=rb,
                       lo=lo if geom_lo is None else geom_lo,
                       hi=hi if geom_hi is None else geom_hi, shift=rshift,
                       pad_cat=not X.pad_cat_safe(lo, hi)
                       if pad_cat is None else pad_cat)
    part, starts = X.partition_pass(X._chunk_pad(rk, chunk, cuda), geom)
    return part, starts, (rb, rshift, rslr)


def _build_check(cuda, part, starts, lo, hi, geo):
    """The kernel's bitmap, built into an allocator block filled with a
    sentinel first, equals the twin's, its slice padding is zero and the
    launch counted once."""
    rb, rshift, rslr = geo
    n = (1 << rb) * rslr * 128
    torch.full((n,), 0x5A5A5A5A, dtype=torch.int32, device=cuda)  # freed
    _build.reset_launches()
    got = B.bitmap_build(part, lo, hi, rb, rshift, rslr, starts)
    want = B.build_bitmap(part, lo, hi, rb, rshift, rslr)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["bitmap_build"] == 1
    assert torch.equal(got, want)
    live = B.live_words(rshift)
    assert not got.view(1 << rb, -1)[:, live:].any()
    return got


@pytest.mark.parametrize("split", list(BUILD_SPLITS))
@pytest.mark.parametrize("case", ["runs_of_one", "pad_cat", "duplicates",
                                  "edge_keys", "one_bucket", "empty_buckets"])
def test_bitmap_build_walks_every_split(cuda, monkeypatch, split, case):
    """The staged build over R's runs against the twin, bit for bit: runs
    of 0-1 keys (1,024 buckets, 8-row chunks), the pad category kept (a
    negative range), R drawn with replacement, keys at lo - 1, lo, hi and
    hi + 1 with PAD and negative keys, every key in one bucket, and R in
    the first and last buckets only."""
    _force_build_split(monkeypatch, split)
    rng = np.random.default_rng(len(case) * 13 + len(split))
    lo, hi, bits, chunk_rows, nchunks = 1, 5_000_000, 6, 64, 4
    n = nchunks * chunk_rows * 128 - 333
    if case == "runs_of_one":
        bits, chunk_rows, n = 10, 8, 5 * 8 * 128 - 50
    if case == "pad_cat":
        lo, hi = -(1 << 20), (1 << 20) - 1
    rk = rng.integers(lo, hi + 1, n)
    if case == "duplicates":
        rk = rng.choice(rng.integers(lo, hi + 1, 500), n)
    if case == "edge_keys":
        u = rng.random(n)
        rk[u < 0.1] = lo - 1
        rk[(u > 0.1) & (u < 0.2)] = hi + 1
        rk[(u > 0.2) & (u < 0.3)] = lo
        rk[(u > 0.3) & (u < 0.4)] = hi
        rk[(u > 0.4) & (u < 0.5)] = PAD
        rk[(u > 0.5) & (u < 0.6)] = rng.integers(-2**31 + 1, 0,
                                                 int(((u > 0.5) & (u < 0.6))
                                                     .sum()))
    pb, shift, _ = B.plan_geometry(lo, hi, bits)
    if case == "one_bucket":
        rk = rng.integers(lo, lo + (1 << shift), n)
    if case == "empty_buckets":
        top = lo + ((hi - lo) >> shift << shift)      # hi's bucket
        rk = np.concatenate([rng.integers(lo, lo + (1 << shift), n // 2),
                             rng.integers(top, hi + 1, n - n // 2)])
    rk = rk.astype(np.int32)
    part, starts, geo = _build_case(cuda, rk, lo, hi, bits, chunk_rows)
    assert B.build_split(part, starts, geo[1], geo[0]) is not None
    got = _build_check(cuda, part, starts, lo, hi, geo)
    in_range = rk[(rk >= lo) & (rk <= hi)]
    assert np.unpackbits(got.cpu().numpy().view(np.uint8)).sum() \
        == len(np.unique(in_range))


@pytest.mark.parametrize("name,lo,hi,bits,geo", [
    ("4d", 1, 16_000_000, 12, (12, 12, 8)),
    ("flagship shift 19", 1, 128_000_000, 8, (8, 19, 128)),
    ("flagship as planned", 1, 128_000_000, None, (9, 18, 64))])
def test_bitmap_build_main_path_geometries(cuda, name, lo, hi, bits, geo):
    """4d's 4,096 slices of 4 KiB (512 live bytes, many buckets a range)
    and the flagship's build geometries (64 KiB slices at shift 19; 32 KiB
    as plan_radix_join plans it) over 3 chunks of a shuffled dense range
    with a PAD tail."""
    rng = np.random.default_rng(geo[0])
    rk = (rng.choice(hi, 3 * 4096 * 128 - 7777, replace=False) + lo) \
        .astype(np.int32)
    part, starts, got_geo = _build_case(cuda, rk, lo, hi, bits, 4096)
    assert got_geo == geo, name
    _build_check(cuda, part, starts, lo, hi, geo)


@pytest.mark.parametrize("case", ["other_range", "in_range_pad_run"])
def test_bitmap_build_keys_outside_their_range(cuda, case):
    """Runs that do not follow the bitmap's buckets: R partitioned over a
    range shifted by 3 buckets (every key in another range's run), and
    with a pad category over a narrower range (in-range keys in the pad
    run): the last CTA's pass over R in device memory keeps the bitmap
    equal to the twin's."""
    rng = np.random.default_rng(len(case))
    lo, hi = 1, 5_000_000
    rk = rng.integers(lo, hi + 1, 3 * 64 * 128 - 99).astype(np.int32)
    pb, shift, _ = B.plan_geometry(lo, hi, 6)
    kw = dict(geom_lo=lo + 3 * (1 << shift)) if case == "other_range" \
        else dict(pad_cat=True, geom_hi=hi // 2)
    part, starts, geo = _build_case(cuda, rk, lo, hi, 6, 64, **kw)
    _build_check(cuda, part, starts, lo, hi, geo)


def test_bitmap_build_flat_class_and_needs_starts(cuda):
    """A slice past the staging budget (shift 21: 256 KiB) takes the flat
    class and equals the twin; without starts, with starts of the wrong
    size or with a key range past the buckets the build raises on the
    card."""
    rng = np.random.default_rng(5)
    lo, hi = 1, 1 << 23
    rk = rng.integers(lo, hi + 1, 2 * 64 * 128).astype(np.int32)
    geo = (2, 21, 512)        # the two-pass plan's build at 2 bits
    part, starts = X.partition_pass(X._chunk_pad(rk, 64 * 128, cuda),
                                    X.RadixGeom(chunk_rows=64, part_bits=2,
                                                lo=lo, hi=hi, shift=21,
                                                pad_cat=False))
    assert B.build_split(part, starts, 21, 2) is None
    _build_check(cuda, part, starts, lo, hi, geo)
    part, starts, geo = _build_case(cuda, rk, lo, hi, 6, 64)
    with pytest.raises(ValueError, match="starts"):
        B.bitmap_build(part, lo, hi, *geo)
    with pytest.raises(ValueError, match="starts"):
        B.bitmap_build(part, lo, hi, *geo, starts[:-128])
    with pytest.raises(ValueError, match="past"):
        B.bitmap_build(part, lo, 2 * hi, *geo, starts)


def _one_bucket_keys(rng, args, bits, n):
    """n keys (not PAD) of hash bucket 0 at `bits` of the block index."""
    hash_bits = (args.nblocks - 1).bit_length()
    found = []
    while sum(len(f) for f in found) < n:
        k = rng.integers(-2**31 + 1, 2**31, 1 << 16, dtype=np.int64) \
            .astype(np.int32)
        block = hashes.hash_crc(args.seed, torch.from_numpy(k)).numpy() \
            & ((1 << hash_bits) - 1)
        found.append(k[block >> (hash_bits - bits) == 0])
    return np.concatenate(found)[:n]


def _prune_check(cuda, words, keys, args, **kw):
    """The kernel's prune into a sentinel-filled buffer equals the twin's
    on every slot of the keys, and leaves the words past them alone."""
    n = keys.numel()
    out = torch.full((n + 256,), 3, dtype=torch.int32, device=cuda)
    got, count = BP.bloom_probe_prune(words, keys, args, out=out, **kw)
    want, wn = BP.bloom_probe_prune_plain(words, keys, args)
    torch.cuda.synchronize()
    assert torch.equal(got[:n], want.reshape(-1)) and int(count) == int(wn)
    assert (got[n:] == 3).all()
    return int(count)


@pytest.mark.parametrize("split", list(PROBE_SPLITS))
@pytest.mark.parametrize("chunk_rows,nchunks,bits,m,B,k", [
    (8, 6, 10, 1 << 22, 512, 1),        # 1,024 buckets: runs of 0-1 keys
    (64, 4, 5, 1 << 22, 512, 3),
    (16, 3, 2, 1 << 16, 32, 8)])
def test_bloom_probe_walks_every_split(cuda, monkeypatch, split, chunk_rows,
                                       nchunks, bits, m, B, k):
    """The staged bloom probe over hash-partition chunks (an all-PAD chunk,
    a chunk of one bucket) against the twin, for the built, an empty and a
    full filter, into an output pre-filled with a sentinel."""
    _force_split(monkeypatch, split)
    rng = np.random.default_rng(bits + k)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=m, k=k, B=B, seed=7)
    chunk = chunk_rows * 128
    add = _hash_keys(rng, 20_000, 0.0)
    s = torch.cat([add[:3000], _hash_keys(rng, nchunks * chunk - 3000)])
    s = s[torch.from_numpy(rng.permutation(s.numel()))]
    s[chunk:2 * chunk] = PAD
    s[2 * chunk:3 * chunk] = torch.from_numpy(
        _one_bucket_keys(rng, args, bits, chunk))
    geom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=bits,
                       hash_seed=args.seed,
                       hash_bits=(args.nblocks - 1).bit_length())
    part, starts = X.partition_pass(s.to(cuda), geom)
    kw = dict(starts=starts, part_bits=bits)
    assert BP.probe_split(part.reshape(-1), args, **kw) is not None
    words = bloom.build_bitmap(add.to(cuda), args)
    kept = _prune_check(cuda, words, part, args, **kw)
    assert kept >= int((torch.isin(s, add) & (s != PAD)).sum()) > 0
    assert _prune_check(cuda, torch.zeros_like(words), part, args, **kw) == 0
    assert _prune_check(cuda, torch.full_like(words, -1), part, args, **kw) \
        == int((s != PAD).sum())


@pytest.mark.parametrize("split", ["planned", "nb3", "lane_runs"])
@pytest.mark.parametrize("chunk_rows,nchunks,b1,b2,m", [
    (64, 5, 3, 3, 1 << 24), (8, 40, 6, 2, 1 << 22)])
def test_bloom_probe_walks_pass2_regions(cuda, monkeypatch, split,
                                         chunk_rows, nchunks, b1, b2, m):
    """The staged bloom probe over hash-mode pass-2 regions: each region's
    PAD tail is written as PAD over a sentinel, every other slot equals the
    twin's, for the built and a full filter."""
    _force_split(monkeypatch, split)
    rng = np.random.default_rng(b1 + b2 + chunk_rows)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=m, k=2, B=512, seed=9)
    hash_bits = (args.nblocks - 1).bit_length()
    keys = _hash_keys(rng, nchunks * chunk_rows * 128)
    s1, st1 = X.partition_pass(keys.to(cuda), X.RadixGeom(
        chunk_rows=chunk_rows, part_bits=b1, hash_seed=args.seed,
        hash_bits=hash_bits))
    p2 = M.plan_pass2(s1, st1, b1, b2, chunk_rows, None, hash_seed=args.seed,
                      hash_bits=hash_bits)
    regions, starts2 = M.pass2_partition(s1, st1, p2)
    kw = dict(starts=starts2, part_bits=b1 + b2, seg_bits=b2)
    split_ = BP.probe_split(regions.reshape(-1), args, **kw)
    assert split_ is not None and split_.regions
    words = bloom.build_bitmap(keys[::4].to(cuda), args)
    assert _prune_check(cuda, words, regions, args, **kw) \
        >= int((keys[::4] != PAD).sum())
    assert _prune_check(cuda, torch.full_like(words, -1), regions, args,
                        **kw) == int((keys != PAD).sum())


def test_bloom_probe_flat_class_past_the_staging_budget(cuda):
    """One bucket of a 2^24-bit filter at 0 partition bits is 2 MiB: the
    flat class, with starts; starts without the partition's bits, or of
    the wrong size, are refused."""
    rng = np.random.default_rng(29)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 24, k=2, B=512)
    keys = _hash_keys(rng, 2 * 64 * 128)
    part, starts = X.partition_pass(keys.to(cuda), X.RadixGeom(
        chunk_rows=64, part_bits=0, hash_seed=args.seed,
        hash_bits=(args.nblocks - 1).bit_length()))
    assert BP.probe_split(part.reshape(-1), args, starts, 0) is None
    words = bloom.build_bitmap(keys[::3].to(cuda), args)
    _prune_check(cuda, words, part, args, starts=starts, part_bits=0)
    with pytest.raises(ValueError):
        BP.bloom_probe_prune(words, part, args, starts=starts)
    with pytest.raises(ValueError):
        BP.bloom_probe_prune(words, part, args, starts=starts[:-128],
                             part_bits=0)


def _key8b_relations(cuda, n_r, n_s, stats=True):
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.types import Relation
    p = G.WorkloadParams(r_size=n_r, s_size=n_s, nthreads=8, key8b=True)
    rk, rp, sk, sp = G.build_workload(p)
    R = Relation.from_numpy(rk, rp, device=cuda, key8b=True,
                            stats=G.r_key_stats(p) if stats else None)
    S = Relation.from_numpy(sk, sp, device=cuda, key8b=True)
    return (rk, rp, sk, sp), R, S


def test_cuda_key8b_at_2_20_x_2_24(cuda):
    """KEY_8B on the card: 16-byte tuples whose high words are zero take
    cuda_key8b, which launches the partition, the bitmap build and probe,
    and counts what ref_join counts."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.models import run_join
    (rk, rp, sk, sp), R, S = _key8b_relations(cuda, 1 << 20, 1 << 24)
    _build.reset_launches()
    res, st, sums = run_join("PRO", R, S, EngineConfig())
    for name in ("partition", "bitmap_build", "bitmap_probe"):
        assert _build.LAUNCHES[name] > 0, name
    assert st.tier == "cuda_key8b" and sums == (0, 0)
    assert res.count() == native.ref_join(rk, rp, sk, sp)[0] == 1 << 24


def test_key8b_plain_tiers_on_card_equal_cpu(cuda):
    """The plain key8b tier (no stats) and materialize8b (a declared unique
    R) on the card give the CPU's count, 64-bit sums and pairs."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.models import run_join
    from hwbloomradixjoin_tpu_torch.types import Relation
    rng = np.random.default_rng(41)
    rk = rng.permutation(np.arange(1, 50_001)).astype(np.int64)
    rk[::7] += 2**32
    sk = rng.choice(rk, 300_000) + rng.integers(0, 2, 300_000) * 2**33
    rp = rng.integers(-2**40, 2**40, len(rk))
    sp = rng.integers(-2**40, 2**40, len(sk))

    def rels(dev, stats):
        from hwbloomradixjoin_tpu_torch.types import KeyStats
        ks = KeyStats(1, int(rk.max()), is_unique=True) if stats else None
        return (Relation.from_numpy(rk, rp, device=dev, key8b=True,
                                    stats=ks),
                Relation.from_numpy(sk, sp, device=dev, key8b=True))
    card = run_join("PRO", *rels(cuda, False), EngineConfig())
    host = run_join("PRO", *rels("cpu", False), EngineConfig())
    assert card[1].tier == host[1].tier == "key8b"
    assert card[0].count() == host[0].count() > 0
    assert card[2] == host[2]
    cfg = EngineConfig(materialize=True)
    card = run_join("PRO", *rels(cuda, True), cfg)
    host = run_join("PRO", *rels("cpu", True), cfg)
    assert card[1].tier == "materialize8b"
    assert sorted(zip(card[0].r_payload.tolist(),
                      card[0].s_payload.tolist())) == \
        sorted(zip(host[0].r_payload.tolist(), host[0].s_payload.tolist()))


def test_cli_pro_on_card(cuda, capsys):
    """The port's CLI in-process on the card: the exact count, stdout the
    measurement harness parses, and --verbose's roofline line."""
    import os
    import sys
    from hwbloomradixjoin_tpu_torch import cli
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "measurements"))
    from run import parse_result
    assert cli.main(["-a", "PRO", "-r", "1000000", "-s", "8000000", "-n",
                     "8", "-q", "0.5", "--engine-no-dense", "--verbose"]) == 0
    out = capsys.readouterr().out
    d = parse_result(out)
    assert d["results"] == d["out-tuples"] == 4_000_000
    assert "roofline" in out


@pytest.mark.parametrize("lo,hi,bits,chunk_rows", [(1, 16_000_000, 6, 1024),
                                                   (-5000, 5000, 3, 64),
                                                   (0, 2**31 - 2, 12, 256)])
def test_radix_cluster_on_card_equals_twin(cuda, lo, hi, bits, chunk_rows):
    """The radix_cluster operator launches kernel 1 and equals its twin on
    the same keys (keys outside [lo, hi] and PAD in the tail), and its
    starts take the (nchunks, cat_rows, 128) shape."""
    from hwbloomradixjoin_tpu_torch.ops import sort
    rng = np.random.default_rng(51)
    keys = rng.integers(max(lo - 100, -2**31 + 1), min(hi + 100, 2**31 - 1),
                        1_000_003).astype(np.int32)
    keys[::29] = PAD
    _build.reset_launches()
    out, starts = sort.radix_cluster(keys, lo, hi, bits, chunk_rows, cuda)
    assert _build.LAUNCHES["partition"] == 1
    want = sort.radix_cluster(keys, lo, hi, bits, chunk_rows, "cpu")
    assert torch.equal(out.cpu(), want[0])
    assert torch.equal(starts.cpu(), want[1])
    assert starts.shape[1:] == (want[1].shape[1], 128)


@pytest.mark.parametrize("values", [False, True])
def test_group_by_key_and_join_group_count_on_card_equal_cpu(cuda, values):
    """group_by_key (sums wrapping past 2^32) and join_group_count on the
    card give the CPU's outputs element for element, and the stable
    radix_sort (descending too) the CPU's order."""
    from hwbloomradixjoin_tpu_torch.ops import aggregate, sort
    rng = np.random.default_rng(53)
    sk = torch.from_numpy(rng.zipf(1.3, 2_000_000).clip(1, 2**31 - 1)
                          .astype(np.int32))
    sk[::101] = PAD
    vals = torch.from_numpy(rng.integers(2**30, 2**31, len(sk))
                            .astype(np.int32)) if values else None
    rk = torch.from_numpy(rng.integers(1, 5000, 300_000).astype(np.int32))
    got = aggregate.group_by_key(sk.to(cuda), None if vals is None
                                 else vals.to(cuda))
    want = aggregate.group_by_key(sk, vals)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    got = aggregate.join_group_count(rk.to(cuda), sk.to(cuda))
    want = aggregate.join_group_count(rk, sk)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    pays = torch.arange(len(sk), dtype=torch.int32)
    for desc in (False, True):
        got = sort.radix_sort(sk.to(cuda), pays.to(cuda), descending=desc)
        want = sort.radix_sort(sk, pays, descending=desc)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.fixture
def nccl_world(cuda):
    """A world of one over NCCL on this process, destroyed after."""
    import torch.distributed as dist
    from hwbloomradixjoin_tpu_torch.parallel import mesh
    group = mesh.make_mesh(1, cuda)
    yield group
    dist.destroy_process_group()


def test_dist_join_world_of_one_over_nccl(cuda, nccl_world):
    """dist_join_count on a world of one over NCCL: the sort-scan engine's
    count and checksums and the bitmap engine's count (kernels 1, 3 and 4
    launched) equal ref_join's, through the blocked filter too (its
    survivors the host filter's)."""
    import torch.distributed as dist
    from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.parallel import dist_join
    assert dist.get_backend() == "nccl"
    # at 2 bits of [1, 2^20] R's dense runs pass JAX's window and set its
    # flag in traced_radix_count; the kernels count them exactly, and the
    # join's overflow counts only tuples the buffers dropped: none
    rk, rp, sk, sp = G.build_workload(G.WorkloadParams(
        r_size=1 << 20, s_size=1 << 23, nthreads=4, selectivity=0.5))
    assert int(B.traced_radix_count(torch.from_numpy(rk),
                                    torch.from_numpy(sk), 1, 1 << 20)[1])
    cnt, sr, ss = native.ref_join(rk, rp, sk, sp)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 23, k=2, B=512)
    after = int(bloom.probe_bitmap_host(bloom.build_bitmap_host(rk, args),
                                        sk, args).sum())
    for engine in ("sortscan", "pallas"):
        for bloom_args in (None, args):
            _build.reset_launches()
            out = [int(v) for v in dist_join.dist_join_count(
                nccl_world, rk, rp, sk, sp, bloom_args=bloom_args,
                local_engine=engine, device=cuda)]
            sums = [0, 0] if engine == "pallas" else [sr % 2**32,
                                                      ss % 2**32]
            assert out == [cnt, *sums, -1 if bloom_args is None else after,
                           0], (engine, bloom_args)
            if engine == "pallas":
                for name in ("partition", "bitmap_build", "bitmap_probe"):
                    assert _build.LAUNCHES[name] > 0, name


def test_traced_radix_count_on_card_equals_twin(cuda):
    """The sync-free local join on the card: kernels 1, 3 and 4, the
    twin's count and JAX's window flag, with and without a key heavy
    enough to set it."""
    rng = np.random.default_rng(57)
    rk = torch.from_numpy((rng.choice(1 << 24, 200_000, replace=False) + 1)
                          .astype(np.int32))
    sk = rng.integers(1, 1 << 25, 3_000_000).astype(np.int32)
    for heavy in (False, True):
        if heavy:
            sk[:40_000] = 12_345
        s = torch.from_numpy(sk)
        got = B.traced_radix_count(rk.to(cuda), s.to(cuda), 1, 1 << 24)
        want = B.traced_radix_count(rk, s, 1, 1 << 24)
        assert [int(v) for v in got] == [int(v) for v in want]
        assert int(got[1]) == int(heavy)


def test_materialize8b_all_pairs_on_card(cuda):
    """materialize8b over a repeated 16-byte R key on the card: every (R,
    S) pair, as the host's all-pairs join and ref_join's count give them."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.models import run_join
    from hwbloomradixjoin_tpu_torch.types import Relation
    rng = np.random.default_rng(59)
    rk = rng.integers(1, 40_000, 60_000).astype(np.int64)
    sk = rng.integers(1, 60_000, 400_000).astype(np.int64)
    rp = rng.integers(-2**31, 2**31, len(rk)).astype(np.int64)
    sp = rng.integers(-2**31, 2**31, len(sk)).astype(np.int64)
    res, st, _ = run_join("PRO", Relation.from_numpy(rk, rp, device=cuda,
                                                     key8b=True),
                          Relation.from_numpy(sk, sp, device=cuda,
                                              key8b=True),
                          EngineConfig(materialize=True))
    pays = {}
    for k, p in zip(rk.tolist(), rp.tolist()):
        pays.setdefault(k, []).append(p)
    want = sorted((r, p) for k, p in zip(sk.tolist(), sp.tolist())
                  for r in pays.get(k, []))
    assert st.tier == "materialize8b"
    assert res.count() == len(want) == native.ref_join(rk, rp, sk, sp)[0]
    assert sorted(zip(res.r_payload.tolist(), res.s_payload.tolist())) == want
