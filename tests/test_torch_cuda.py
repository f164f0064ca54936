"""PyTorch port on the card: each CUDA kernel against its plain twin.

Every test takes the `cuda` fixture and skips where no CUDA device exists (a
CUDA kernel has no CPU mode); chip_smoke.py covers the main path's geometry,
these cover the edges: tiny and odd chunks, 0 to 13 partition bits, pad
category dropped, no range prune, negative and near-2^31 key ranges, padded
and deep bitmap slices, and the launch counters.  This file imports no jax,
so on a machine without it run:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu_torch.kernels import _build
from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
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
                               "bitmap_build": 0, "bitmap_probe": 0}
    with pytest.raises(ValueError):
        X.partition_pass(keys.to(cuda).long(), geom)
    with pytest.raises(ValueError):
        X.partition_pass(torch.arange(8 * 129, dtype=torch.int32,
                                      device=cuda)[1:8 * 128 + 1], geom)
