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
from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
from hwbloomradixjoin_tpu_torch.data import generator as TG
from hwbloomradixjoin_tpu_torch.ops import bitmap_join as TB
from hwbloomradixjoin_tpu_torch.ops import bloom_pallas as TBP
from hwbloomradixjoin_tpu_torch.ops import radix as TX
from hwbloomradixjoin_tpu_torch.ops import run_split
from port_cpu import lean_cpu  # noqa: F401  (autouse)

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
    got = plan.build(*plan.r_partition())
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
                                shift, pb, slr,
                                torch.from_numpy(np.array(starts)))
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


# The probes' main-path shapes: kernel, segments, rows a segment, bucket
# bits a segment, bucket bits in all, and the bitmap's shift or the filter's
# m.  PRO 16M x 128M at q = 1 (245 chunks, 64 slices of 32 KiB), 4d's pass-2
# regions (64 of 64 sub-buckets, 512 live bytes a slice), PRO at q = 0.01
# after compaction (3 chunks), 4e's hash partition (245 chunks, 1,024
# slices of 16 KiB) and the flagship's regions (1,024 of 8 sub-buckets).
# Last, whether the staged class takes it (the bitmap probe's flat class
# takes 4d's 512-byte live slices and the 3 compacted chunks at q = 0.01).
PROBE_SHAPES = {
    "bitmap PRO q=1": ("bitmap", 245, 4096, 6, 6, 18, True),
    "bitmap 4d": ("bitmap", 64, 17_664, 6, 12, 12, False),
    "bitmap PRO q=0.01": ("bitmap", 3, 4096, 6, 6, 18, False),
    "bloom 4e": ("bloom", 245, 4096, 10, 10, 1 << 27, True),
    "bloom flagship": ("bloom", 1024, 9_776, 3, 13, 1 << 30, True),
}


@pytest.mark.parametrize("shape", list(PROBE_SHAPES))
def test_probe_split_walks_every_run_once(monkeypatch, shape):
    """The host's split of the staged probes (sizes only, meta tensors):
    the class each main-path shape takes; then, with the bitmap probe's
    size rules lifted where it takes the flat class, the CTAs' bucket
    ranges and spans cover every (segment, bucket) run once, their pad
    shares tile each pad run, regions stage their own buckets, the grid
    fills the card; the wrappers refuse starts of the wrong size and, on
    the CPU, count and prune as without them."""
    kind, nseg, rows, seg_bits, bits, geo, staged = PROBE_SHAPES[shape]
    cat_words = TX.RadixGeom(part_bits=seg_bits).cat_rows * 128
    keys = torch.empty(nseg * rows * 128, dtype=torch.int32, device="meta")
    starts = torch.empty(nseg * cat_words, dtype=torch.int32, device="meta")
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=geo, k=1, B=512) \
        if kind == "bloom" else None

    def split_of(st, k=keys):
        if kind == "bitmap":
            return TB.probe_split(k, st, geo, bits, seg_bits)
        return TBP.probe_split(k, args, st, bits, seg_bits)

    assert (split_of(starts) is not None) == staged
    monkeypatch.setattr(TB, "PROBE_MIN_SLICE", 0)
    monkeypatch.setattr(TB, "PROBE_MIN_KEYS_A_WORD", 0)
    split = split_of(starts)
    assert split is not None and split.regions == (seg_bits < bits)
    fs = 1 << seg_bits
    seen = np.zeros((nseg, fs), np.int64)
    for cta in range(split.ctas):
        rng, j0, j1, s0, s1, gb0 = run_split.cta_work(split, cta)
        assert j0 < j1 and s0 < s1
        assert gb0 == (s0 * fs + j0 if split.regions else j0)
        seen[s0:s1, j0:j1] += 1
    assert (seen == 1).all()
    for pad_begin in (0, 77, rows * 128 - 5, rows * 128 + 9):
        shares = [run_split.pad_share(split, r, pad_begin)
                  for r in range(split.nranges)]
        assert shares[0][0] == min(pad_begin, rows * 128)
        assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        assert shares[-1][1] == rows * 128
    assert split.ctas >= (2 * run_split.H100_SMS if nseg > 3 else 64)
    for bad in (starts[:-128], torch.empty(cat_words * nseg + 1,
                                           dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError):
            split_of(bad)
    if split.regions:                     # regions of the wrong count
        with pytest.raises(ValueError):
            split_of(starts[:cat_words * (nseg // 2)],
                     keys[:keys.numel() // 2])
        return
    # a small partition of the same bucket bits on the CPU: the wrappers
    # take its starts, refuse a cut table, and give the flat results
    rs = np.random.default_rng(seg_bits)
    small = rs.integers(-2**31 + 1, 2**31, 3 * 8 * 128, dtype=np.int64)
    small[::9] = -2**31
    small = torch.from_numpy(small.astype(np.int32))
    if kind == "bitmap":                  # 2^7 keys a bucket: 8-row slices
        lo, shift = 1, 7
        geom = TX.RadixGeom(chunk_rows=8, part_bits=bits, lo=lo,
                            hi=(1 << (bits + shift)) - 1 + lo, shift=shift)
        small[::2] = small[::2] & ((1 << (bits + shift)) - 1)
        part, st = TX.partition_pass(small, geom)
        bm = torch.from_numpy(rs.integers(-2**31, 2**31, (64 * 8, 128),
                                          dtype=np.int64).astype(np.int32))
        probe = (bm, part, lo, shift, bits, 8)
        want = TB.bitmap_probe_count(*probe)
        assert int(TB.bitmap_probe_count(*probe, st)) == int(want) > 0
        with pytest.raises(ValueError):
            TB.bitmap_probe_count(*probe, st[:-128])
    else:
        hash_bits = (args.nblocks - 1).bit_length()
        geom = TX.RadixGeom(chunk_rows=8, part_bits=bits,
                            hash_seed=args.seed, hash_bits=hash_bits)
        part, st = TX.partition_pass(small, geom)
        words = torch.zeros(args.m // 32, dtype=torch.int32)
        words[::3] = -1
        want = TBP.bloom_probe_prune(words, part, args)
        got = TBP.bloom_probe_prune(words, part, args, starts=st,
                                    part_bits=bits)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])
        with pytest.raises(ValueError):
            TBP.bloom_probe_prune(words, part, args, starts=st[:-128],
                                  part_bits=bits)


# The build's main-path shapes: chunks, bucket bits, shift, keys of R (the
# rest of the last chunk is PAD, in PAD's bucket: no pad category), and the
# split the planner gives (buckets a range, CTAs a range).  PRO 16M x 128M
# (64 slices of 32 KiB), 4d (4,096 slices of 512 live bytes) and the
# flagship (128M keys, 512 slices of 32 KiB, as plan_radix_join plans it).
BUILD_SHAPES = {
    "PRO": (31, 6, 18, 16_000_000, 1, 8),
    "4d": (31, 12, 12, 16_000_000, 32, 4),
    "flagship": (245, 9, 18, 128_000_000, 1, 1),
}


@pytest.mark.parametrize("shape", list(BUILD_SHAPES))
def test_build_split_walks_every_key_once(shape):
    """The host's split of the staged build at each main-path shape (sizes
    only, a starts table of even runs with the chunks' padding in PAD's
    bucket): its ranges and CTAs a range; in the padding's
    range and three others, the walks of the range's CTAs
    (run_split.share_pieces, the kernel's own arithmetic) tile each chunk's
    merged run and the range's share of its pad run once, and each CTA
    walks an even part of the range (the padding's range too)."""
    nseg, bits, shift, n_r, nb, share = BUILD_SHAPES[shape]
    chunk = TB.CHUNK_ROWS * 128
    fs = 1 << bits
    cat_words = TX.RadixGeom(part_bits=bits).cat_rows * 128
    keys = torch.empty(nseg * chunk, dtype=torch.int32, device="meta")
    starts = torch.empty(nseg * cat_words, dtype=torch.int32, device="meta")
    split = TB.build_split(keys, starts, shift, bits)
    pad_bucket = ((2**31 - 1) >> shift) % fs
    assert (split.nb, split.share) == (nb, share)
    assert split.ctas >= 3 * run_split.H100_SMS
    assert split.nb * 4 * TB.live_words(shift) + split.table_bytes \
        <= TB.BUILD_MAX_SMEM
    counts = np.full((nseg, fs), chunk // fs, np.int64)
    counts[-1] = (n_r - (nseg - 1) * chunk) // fs
    counts[-1, pad_bucket] += chunk - counts[-1].sum()
    table = np.zeros((nseg, cat_words), np.int64)
    table[:, 1:fs + 1] = np.cumsum(counts, axis=1)
    table[:, fs + 1:] = chunk
    nr = split.nranges
    for rng in {pad_bucket // split.nb, 0, nr // 2, nr - 1}:
        j0, j1 = rng * split.nb, (rng + 1) * split.nb
        want = [(s, table[s, j0], table[s, j1]) for s in range(nseg)]
        total = sum(b - a for _, a, b in want)
        seen, walked = [], []
        for rank in range(split.share):
            cta = rng * split.share + rank
            pieces = [p for p in run_split.share_pieces(split, table, cta)
                      if p[1] < p[2]]
            seen += pieces
            walked.append(sum(b - a for _, a, b in pieces))
        assert max(walked) - min(walked) <= 1 and sum(walked) == total
        seen.sort()
        merged = [list(seen[0])]
        for s, a, b in seen[1:]:
            if s == merged[-1][0] and a == merged[-1][2]:
                merged[-1][2] = b
            else:
                merged.append([s, a, b])
        assert [tuple(m) for m in merged] == [w for w in want if w[1] < w[2]]


@pytest.mark.parametrize("pad_cat", [False, True])
def test_bitmap_build_takes_starts_on_the_cpu(pad_cat):
    """On the CPU the build with R's starts equals the build without them
    and the twin (keys at lo - 1, hi + 1, PAD and duplicates in R); starts
    of the wrong size raise, from the wrapper and from the twin."""
    rng = np.random.default_rng(int(pad_cat))
    lo, hi = 1, 60_000
    rk = rng.integers(lo, hi + 1, 3 * 8 * 128 - 100)
    rk[::7] = rk[1::7][:len(rk[::7])]
    rk[::11] = lo - 1
    rk[::13] = hi + 1
    rk[::17] = PAD
    pb, shift, slr = TB.plan_geometry(lo, hi, 4)
    part, st = TX.partition_pass(
        TX._chunk_pad(rk.astype(np.int32), 8 * 128, "cpu"),
        TX.RadixGeom(chunk_rows=8, part_bits=pb, lo=lo, hi=hi, shift=shift,
                     pad_cat=pad_cat))
    want = TB.build_bitmap(part, lo, hi, pb, shift, slr)
    assert torch.equal(TB.bitmap_build(part, lo, hi, pb, shift, slr, st),
                       want)
    assert torch.equal(TB.bitmap_build(part, lo, hi, pb, shift, slr), want)
    assert torch.equal(TB.build_bitmap(part, lo, hi, pb, shift, slr, st),
                       want)
    assert TB.build_split(part, st, shift, pb) is not None
    for bad in (st[:-128], st.reshape(-1)[:-1]):
        with pytest.raises(ValueError):
            TB.bitmap_build(part, lo, hi, pb, shift, slr, bad)
        with pytest.raises(ValueError):
            TB.build_bitmap(part, lo, hi, pb, shift, slr, bad)
