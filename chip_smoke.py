#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root.  Every failure raises (non-zero exit).  Phases:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels (csrc/*.cu, one nvcc per source, in
   parallel) into the package's git-ignored build directory and prints the
   build time;
3. kernel vs twin: each of the fifteen kernel rows against its plain
   PyTorch twin on the card on 4 chunks of CHUNK_ROWS=4096 rows: the PRO
   kernels at plan_geometry(1, 16_000_000), the count-table kernels at
   workload B's count geometry plan_geometry_counts(1, 128_000_000) =
   (13, 14, 128) with
   a non-unique R and an S holding PAD, keys below lo and keys above hi;
   the bitmap build walks the R partition's starts (its staged class: a
   cluster of CTAs a bucket range); the bitmap probe walks the S
   partition's starts (its staged class) and, at 2 bits (512 KiB slices),
   takes its flat class;
   3d. the bitmap build at 4d's geometry (12 bits, 4 KiB slices of 512 live
   bytes) and at the flagship's build geometry (8 bits of [1, 128M], 64 KiB
   slices), R with a PAD tail in a junk bucket; the bloom kernels: the
   hash-mode partition at the flagship's pass-1
   geometry (10 of 21 bits), pass 2 in range mode (b1 = b2 = 6 over
   [1, 16M]) and in hash mode (b1 = 10, b2 = 3), the bitmap probe over the
   range regions, and the bloom probe against m = 2^30, B = 512 filters at
   k = 1, 2 and 4 in every class (staged over the hash regions and over
   pass 1's chunks, flat without starts) and against m = 2^27 over a 10-bit
   hash partition, over an S holding PAD, negative keys and keys at or
   above 2^31 - 2^20; each k's survivors also equal the plain prune's on
   the card and the reference filter's (native.ref_bloom) on the host;
   3f. the partition, the bitmap build and the bitmap probe at the full
   int32 span's geometry (13, 18, 64), R's PAD category on, over
   validate_fullrange's workload (2 + 4 chunks), the count the host's;
   3e. the dense count (keys at lo - 1 and hi + 1, negative keys, PAD,
   payloads at +-2^31 so the sum wraps, a length with a 3-key tail),
   materialization at the count geometry of [1, 16M] (R payloads equal to
   PAD kept as pairs) and the gathered probe at the JAX default geometry
   (12 low bits) over a duplicate-heavy R, then with one bucket of R_CAP + 1
   keys, which must report overflow, then with buckets of R_CAP, 12,000 and
   3,000 keys (every capacity class of its hash table);
   integer outputs must match bit for bit;
4. the PRO path: run_join("PRO") on 16M ⋈ 128M uniform at q=1 and q=0.01;
4b. workload B (128M ⋈ 128M, q=1, payloads on the card): run_join for PRHO,
   PRH and NPO; the tier must be cuda_prho / cuda_prh / cuda_npo, the count
   128,000,000 and the checksums those of the plain ht tier on the same card
   (PRH's S checksum is 0);
4c. PRO over a non-unique build (16M ⋈ 128M, --non-unique generators): the
   tier must be cuda_prho, count and checksums those of the ht tier;
4d. two-pass PRO 16M ⋈ 128M at q = 1, RadixConfig(passes=2,
   num_radix_bits=12): the two-pass plan (6 + 6 bits), count 128,000,000,
   its bitmap build (12 bits) equal to the twin's bit for bit
   (and in phase 5 one line of pass 2's ms and ns a key at b2 = 3, 6 and
   10 over its S, each equal to the twin);
4e. BPRO 16M ⋈ 128M at q = 0.01 with a blocked filter (k = 1, m = 2^27,
   B = 512): one 10-bit hash pass, exact count, S-tuples after filter
   equal to the plain prune's on the card, the build equal to the twin's;
4p. the validation tools at full size: validate_fullrange's PRO and BPRO
   (blocked, m = 2^30, k = 4, B = 512) over a sparse unique R of 16M keys
   over [1, 2^31) and 128M S keys whose misses lie inside R's span (plan
   (13, 18, 64), R's PAD category, the host's count), and validate_bloom's
   BPRO over 4's q = 0.01 relations at k = 2 and 4 (m = 2^30): each count
   exact, S-tuples after filter the plain prune's on the card, the
   survivor share within 20 % of p + (1 - p) fpr (p the real match share),
   the kernels of each path launched, one time line each;
4f. BRJ 128M ⋈ 1.024B at q = 0.01, blocked, k = 1, m = 2^30, B = 512 (the
   reference's headline bloom run, BASELINE.md:43): the two-pass prune
   (10 + 3 bits), the same checks (the build at 8 bits of 64 KiB slices
   over 128M R keys), and the survivor share beside the reference's
   12.14 %; then the filter build's kernel row at this shape (128M R
   keys, m = 2^30, B = 512, k = 1): its ms and its twin's, both bounds
   (streaming the keys and the words, and a sector read and written a
   key), the words equal to the twin's and to the reference filter's
   (native.ref_bloom) bit for bit;
   every run_join above uses allow_dense=False;
4g. run_join("PRO") with EngineConfig() over 4's relations (the generator's
   dense PK) at q = 1 and q = 0.01: the dense tier, the exact count and the
   S checksum of the ht tier on the card;
4h. EngineConfig(materialize=True) over the same relations at q = 1
   (128,000,000 pairs) and q = 0.01: the cuda_materialize tier, the exact
   count, and the pair multiset of the portable sort_scan_materialize on
   the card; then one line of the table probe's phase time at 13 (4b) to
   17 bits (4j) and materialize's at q = 1 and 0.01;
4i. radix_join_count (the general radix count join: 12 low bits, the
   gathered probe) over 4's q = 1 relations: 128,000,000, no overflow; one
   line of the probe's capacity class and CTAs an SM at its largest bucket;
4j. workload B's relations (4b's) under PRHO with
   RadixConfig(num_radix_bits=b) for b = 14..17, past the port's former
   13-bit single-pass limit: tier cuda_prho, 4b's count and checksums; then
   one line of the partition's ms and ns a key, keys only and with
   payloads, at 6 to 17 bits over workload B's S;
4k. workload A (KEY_8B, rerun-experiments.sh:52-60): PRO 2^24 ⋈ 2^28 over
   16-byte tuples at q = 1: the tier must be cuda_key8b (the partition,
   bitmap build and probe over the low words, launched), the count 2^28;
   the plan-time high-word check's ms; then the plain key8b tier on the same
   relations (R without stats): the count, 64-bit sums equal to ref_join's
   on the low words, its peak device memory; then materialize8b at 2^20 ⋈
   2^24: the count and the int64 pair multiset of the host's;
4l. PRO 16M ⋈ 128M with a Zipf S (z = 1.0 over R's keys): cuda_radix, the
   count |S|, the host generation time, the hottest key's share of S and
   the bitmap probe's largest CTA share of the keys it walks (beside the
   uniform q = 1 S's);
4m. the distributed join (parallel/dist_join.py) on a world of one over
   NCCL at 4's relations: the sort-scan and bitmap local engines at q = 1
   and q = 0.01 (count and checksums the ht tier's on the card; the bitmap
   engine launches kernels 1, 3 and 4), and through 4e's blocked filter at
   q = 0.01, its S-tuples after filter run_join's in the same call; each
   time beside run_join's;
4n. the standalone operators: radix_cluster over 4's S (128M keys, 6
   bits: kernel 1, its twin's output), radix_sort of 128M (key, row)
   rows (ordered, stable), and, over 4l's Zipf S, group_by_key (counts
   total |S|, sums the values' mod 2^32, the host's group count, a 2^20-row
   slice equal to the CPU's) and join_group_count with R (totals the
   join's count); each timed;
4o. 4 gloo processes sharing the card (parallel/multiproc.py's dry run,
   2^22 ⋈ 2^25): the filter, a heavy key and a Zipf S with skew handling,
   the Zipf S without it, the bitmap engine; every result the host's;
   every run of 4-4n has the launch counts reset just before and read just
   after; every kernel of its path must have launched;
5. kernel and twin times at the main paths' full shapes (the bloom kernels
   over 4d's and 4e's S, pass 2 in hash mode at the flagship's 10 + 3 bits,
   where the twins fit beside the data; the dense count, materialization
   and the gathered probe over 4g's, 4h's and 4i's q = 1 inputs), where
   each kernel's output must
   again equal its twin's bit for bit, beside each kernel's bound (bytes
   moved over the card's memory rate, or int32 operations over its int32
   rate); then one line of the class, split, CTAs and resident CTAs an SM
   that the bitmap build and the bitmap and bloom probes take at PRO q = 1
   and q = 0.01, 4d, 4e and the flagship;
6. entry points, each in its own process on the card: the port's CLI
   (``python -m hwbloomradixjoin_tpu_torch.cli``) at 4e's command line,
   with --key8b at workload A, -z 1.0 at 16M ⋈ 128M, -a PRHO at 2^24 ⋈
   2^24, --materialize --out-file (the pairs read back with the port's
   tblio against the host's), --verbose (the H100 roofline) and
   --engine-trace (a trace file), --engine-devices 1 at 16M ⋈ 128M with
   each local engine (tier dist[1]/<engine>, no [WARN ] line), each
   Results line exact and the output
   parsed by the port's measurements.run.parse_result; confrun on a JSON
   conf; unittests tests 0 and 1 (the closed-form (h, y));
6b. the port's sweep driver (python -m
   hwbloomradixjoin_tpu_torch.measurements.run's quick sweep, in process):
   three CLI subprocesses on the card, each row parsed, with its tier and
   an exact Results line;
7. the tools, each through its main() in process as ``python -m
   hwbloomradixjoin_tpu_torch.tools.<tool>`` runs it, each exiting 0:
   validate_pro (PRO 1M x 8M and 16M x 128M, count |S|), build_check (2M
   x 16M: kernel 3's bitmap equal to the twin's, both counts the host's),
   part_bench --widths over 16M keys (kernel 1 at 1-13 bits, each width's
   first chunk the twin's, and the fitted slope), microbench (the card's
   primitives at N = 128M, NR = 16M, each checked once) and validate_key8b
   at 2^20 x 2^24 (tier cuda_key8b, count |S|); then
   measurements.analysis over phase 6b's rows: every row on this card, a
   footprint class from its L2, and a bloom-superiority fraction that is
   a number.

Prints, in order: the card line, each phase's results and wall time, a
{"kernels": [...]} JSON line, and as the last line {"ok": true, "device":
{...}}.
"""

import json
import os
import subprocess
import time

import numpy as np

R_SIZE = 16_000_000          # the PRO path: 16M ⋈ 128M
S_SIZE = 128_000_000
B_SIZE = 128_000_000          # workload B: 128M ⋈ 128M (BASELINE.md, fig. 11)
NU_R_SIZE = 16_000_000        # non-unique build side, 16M ⋈ 128M
FLAG_R_SIZE = 128_000_000     # the bloom flagship: 128M ⋈ 1.024B
FLAG_S_SIZE = 1_024_000_000
REF_SURVIVOR_PCT = 12.14      # its S-tuples after filter (BASELINE.md:43)
WIDE_BITS = (14, 15, 16, 17)   # 4j: workload B past the former 13-bit limit
PASS2_WIDTHS = (3, 6, 10)     # pass 2's cost a key over 4d's S
PART_WIDTHS = (6, 7, 8, 9, 10, 12, 13, 14, 17)   # the partition's cost a key
A_R_SIZE = 1 << 24            # workload A (KEY_8B, 16-byte tuples): 2^24 ⋈
A_S_SIZE = 1 << 28            # 2^28 (rerun-experiments.sh:52-60)
A_MAT_R_SIZE = 1 << 20        # materialize8b: 2^20 ⋈ 2^24
A_MAT_S_SIZE = 1 << 24
ZIPF_Z = 1.0                  # the Zipf PRO cell: S Zipf over R's 16M keys
BLOOM_KS = (1, 2, 4)          # bits a key in its block: validate_bloom's k
PAD_KEY = -2**31
SRC = "hwbloomradixjoin_tpu_torch/csrc/"
KERNELS = {   # wrapper name -> (route, source, TPU kernel it replaces)
    "partition": ("cuda", SRC + "radix.cu",
                  "hwbloomradixjoin_tpu/ops/radix.py:428"),
    "compact": ("cuda", SRC + "radix.cu",
                "hwbloomradixjoin_tpu/ops/radix.py:281"),
    "bitmap_build": ("cuda", SRC + "bitmap_join.cu",
                     "hwbloomradixjoin_tpu/ops/bitmap_join.py:345"),
    "bitmap_probe": ("cuda", SRC + "bitmap_join.cu",
                     "hwbloomradixjoin_tpu/ops/bitmap_join.py:223"),
    "partition_kv": ("cuda", SRC + "radix.cu",
                     "hwbloomradixjoin_tpu/ops/radix.py:499"),
    "table_build": ("cuda", SRC + "prho_join.cu",
                    "hwbloomradixjoin_tpu/ops/prho_join.py:81"),
    "table_probe": ("cuda", SRC + "prho_join.cu",
                    "hwbloomradixjoin_tpu/ops/prho_join.py:252"),
    "partition_hash": ("cuda", SRC + "radix.cu",
                       "hwbloomradixjoin_tpu/ops/radix.py:435"),
    "pass2_partition": ("cuda", SRC + "multipass.cu",
                        "hwbloomradixjoin_tpu/ops/multipass.py:69"),
    "pass2_partition_hash": ("cuda", SRC + "multipass.cu",
                             "hwbloomradixjoin_tpu/ops/multipass.py:89"),
    "bloom_probe": ("cuda", SRC + "bloom.cu",
                    "hwbloomradixjoin_tpu/ops/bloom_pallas.py:93"),
    "dense_count": ("cuda", SRC + "dense_join.cu",
                    "hwbloomradixjoin_tpu/ops/dense_join.py:32"),
    "materialize": ("cuda", SRC + "prho_join.cu",
                    "hwbloomradixjoin_tpu/ops/prho_join.py:647"),
    "gathered_probe": ("cuda", SRC + "gathered_probe.cu",
                       "hwbloomradixjoin_tpu/ops/radix.py:577"),
    "bloom_build": ("cuda", SRC + "bloom.cu",
                    "no Pallas kernel: the XLA build_bitmap_xla, "
                    "hwbloomradixjoin_tpu/ops/bloom.py:97"),
}
# The least time the card could take: the larger of the bytes each function
# must move (each input read once, each output written once) over the
# memory rate and its operations over the peak rate, H100 SXM figures of the
# data sheet.  The kernels do scalar int32 work.  The data sheet's 67e12
# float32 operations a second count an FMA as two on 128 lanes an SM; int32
# issues on 64 lanes an SM, one operation each: 67e12 / 4.  OPS_PER_ELEM
# counts the integer operations per input element of each function.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# A crc32c is 4 table lookups and 12 shifts, masks and xors; the hash
# partition needs one a key (its kernel computes it once), hash-mode pass 2
# takes one in its histogram and one in its scatter; the bloom probe one
# crc32c, one crapwow (2 products, 2 high products, 6 more) and 8 operations
# a probe position at k = 1; the filter build the same hashes and 4
# operations a position (its address and bit), its atomic counted in the
# bytes.  The gathered probe's function, a per-bucket
# count of equal keys, needs no more than a shared-memory hash insert of
# each R key and a hash probe of each S key (a product, a shift, a load, a
# compare, an add and a loop step).
OPS_PER_ELEM = {"partition": 14, "compact": 3, "bitmap_build": 7,
                "bitmap_probe": 9, "partition_kv": 14, "table_build": 8,
                "table_probe": 10, "partition_hash": 14 + 16,
                "pass2_partition": 20, "pass2_partition_hash": 20 + 2 * 16,
                "bloom_probe": 16 + 10 + 8 + 4, "dense_count": 5,
                "materialize": 13, "gathered_probe": 6,
                "bloom_build": 16 + 10 + 4}
# No single PyTorch call computes any of these functions; why, per kernel.
NO_LIBRARY_CALL = {
    "partition": "torch.sort orders by a category computed first; the starts "
                 "need a searchsorted",
    "compact": "a stable live-first order needs a sort, a gather and a mask",
    "bitmap_build": "scatter_reduce has no bitwise OR",
    "bitmap_probe": "a gather, a bit test and a sum",
    "partition_kv": "as partition, plus a gather of the payloads",
    "table_build": "index_add_ fills one table from slots computed first",
    "table_probe": "gathers from two tables, masked products and three sums",
    "partition_hash": "a crc32c category to compute first, then a sort and "
                      "a searchsorted",
    "pass2_partition": "a gather of each bucket's runs, a category, a sort "
                       "per region and a searchsorted",
    "pass2_partition_hash": "as pass2_partition, with a crc32c category",
    "bloom_probe": "two hashes, a gather of filter words, a bit test, a "
                   "where and a sum",
    "dense_count": "a range mask, its sum and a masked payload sum",
    "materialize": "a bucket test, two gathers from the tables and three "
                   "masked selects",
    "gathered_probe": "a sort of R, two searchsorteds of S and a per-bucket "
                      "capacity test",
    "bloom_build": "scatter_reduce has no bitwise OR: two hashes, a bool "
                   "map filled by index_fill_ and packed to words",
}


def max_abs_err(got, want) -> int:
    """Largest absolute difference of two integer results (0 = bit-exact)."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def record(err: dict, name: str, got, want) -> None:
    """Fold a kernel-vs-twin difference into err[name]; raise if not 0."""
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    e = max(max_abs_err(g, w) for g, w in zip(got, want))
    err[name] = max(err.get(name, 0), e)
    if e:
        raise AssertionError(f"{name}: kernel differs from twin by {e}")


def compare_kernels(dev, rng, err) -> None:
    """Phase 3, PRO kernels: each against its twin, on the card, same inputs."""
    import torch
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import radix as X

    lo, hi = 1, R_SIZE
    chunk_rows = B.CHUNK_ROWS
    chunk = chunk_rows * 128
    pb, shift, slr = B.plan_geometry(lo, hi)
    rb, rshift, rslr = B.plan_build_geometry(lo, hi, pb, shift, slr)
    nchunks = 4
    # R: unique in-range keys with a PAD tail (pad category dropped, as the
    # plan does for R); S: hits, misses, out-of-range keys and PAD
    n = nchunks * chunk
    rk = rng.choice(np.arange(lo, hi + 1, dtype=np.int32),
                    min(n - 777, (hi - lo + 1) // 2), replace=False)
    sk = pro_stream(rng, n, lo, hi)
    r_in = X._chunk_pad(rk, chunk, dev)
    s_in = torch.from_numpy(sk).to(dev)
    rgeom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=rb, lo=lo, hi=hi,
                        shift=rshift, pad_cat=not X.pad_cat_safe(lo, hi))
    sgeom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=pb, lo=lo, hi=hi,
                        shift=shift)
    for keys, geom in ((r_in, rgeom), (s_in, sgeom)):
        record(err, "partition", X.partition_pass(keys, geom),
               X.partition_pass_plain(keys, geom))
    r_part, r_starts = X.partition_pass(r_in, rgeom)
    s_part = X.partition_pass(s_in, sgeom)[0]
    for cap in (None, 8, 48):
        record(err, "compact",
               X.compact_pass(s_in, lo, hi, chunk_rows, cap_rows=cap),
               X.compact_pass_plain(s_in, lo, hi, chunk_rows, cap_rows=cap))
    if B.build_split(r_part, r_starts, rshift, rb) is None:
        raise AssertionError("the build took the flat class at PRO's "
                             "geometry")
    bm = B.bitmap_build(r_part, lo, hi, rb, rshift, rslr, r_starts)
    record(err, "bitmap_build", bm,
           B.build_bitmap(r_part, lo, hi, rb, rshift, rslr))
    # the probe's two classes: these 4 chunks are under 8 keys a bitmap
    # word (the flat class); 16 chunks of the same mix take the staged one
    sk16 = pro_stream(rng, 16 * chunk, lo, hi)
    counts = []
    for keys, staged in ((sk, False), (sk16, True)):
        part, starts = X.partition_pass(torch.from_numpy(keys).to(dev), sgeom)
        if (B.probe_split(part, starts, shift, pb) is not None) != staged:
            raise AssertionError(f"the probe of {len(keys)} keys did not "
                                 f"take the {'staged' if staged else 'flat'}"
                                 f" class")
        got = B.bitmap_probe_count(bm, part, lo, shift, pb, slr, starts)
        record(err, "bitmap_probe", got,
               B.bitmap_probe_count_plain(bm, part, lo, shift, pb, slr))
        truth = int(np.isin(keys[(keys >= lo) & (keys <= hi)], rk).sum())
        if int(got) != truth:
            raise AssertionError(f"probe count {int(got)} != numpy {truth}")
        counts.append(truth)
    print(f"kernel vs twin: bit-exact at geometry probe {(pb, shift, slr)} "
          f"build {(rb, rshift, rslr)}, {nchunks} chunks of {chunk} keys, "
          f"probe counts {counts} (flat class; staged over 16 chunks)",
          flush=True)


def pro_stream(rng, n, lo, hi) -> np.ndarray:
    """n S keys for the PRO kernels: in [lo, hi], above hi, below lo, and
    the last 1,000 PAD."""
    u = rng.random(n)
    sk = rng.integers(lo, hi + 1, n)
    sk[u < 0.3] = rng.integers(hi + 1, 2**31 - 1, int((u < 0.3).sum()))
    sk[u < 0.05] = rng.integers(-2**31 + 1, lo, int((u < 0.05).sum()))
    sk = sk.astype(np.int32)
    sk[-1000:] = PAD_KEY
    return sk


def compare_build_geometries(dev, rng, err) -> None:
    """Phase 3d, the bitmap build against its twin on 4 chunks at 4d's
    geometry (12 bits of [1, 16M]: 4 KiB slices, 512 live bytes) and at the
    flagship's build geometry (8 bits of [1, 128M]: 64 KiB slices): R
    unique in range with a PAD tail, partitioned as the plans do (no pad
    category: PAD in a junk bucket's run)."""
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import radix as X

    chunk = B.CHUNK_ROWS * 128
    shapes = []
    for hi, bits in ((R_SIZE, 12), (FLAG_R_SIZE, None)):
        pb, shift, slr = B.plan_geometry(1, hi, bits)
        rb, rshift, rslr = B.plan_build_geometry(1, hi, pb, shift, slr)
        rk = rng.choice(hi, 4 * chunk - 5000, replace=False).astype(np.int32)
        r_in = X._chunk_pad(rk + 1, 4 * chunk, dev)
        rgeom = X.RadixGeom(chunk_rows=B.CHUNK_ROWS, part_bits=rb, lo=1,
                            hi=hi, shift=rshift,
                            pad_cat=not X.pad_cat_safe(1, hi))
        r_part, r_starts = X.partition_pass(r_in, rgeom)
        split = B.build_split(r_part, r_starts, rshift, rb)
        if split is None:
            raise AssertionError(f"the build at {(rb, rshift)} took the flat "
                                 f"class")
        record(err, "bitmap_build",
               B.bitmap_build(r_part, 1, hi, rb, rshift, rslr, r_starts),
               B.build_bitmap(r_part, 1, hi, rb, rshift, rslr))
        shapes.append(f"{(rb, rshift, rslr)} (nb={split.nb} "
                      f"share={split.share})")
    print(f"kernel vs twin: bit-exact bitmap build at 4d's geometry "
          f"{shapes[0]} and the flagship's build geometry {shapes[1]}",
          flush=True)


def compare_fullrange_kernels(dev, rng, err) -> None:
    """Phase 3f: kernels 1, 3 and 4 against their twins on 2 chunks of R
    and 4 of S at the full int32 span's geometry, plan_geometry(1, 2^31 - 1) = (13, 18, 64):
    8,192 buckets, 32 KiB slices, R's PAD category on (pad_cat_safe is
    false), S with PAD.  R and S are validate_fullrange's workload: a
    sparse unique R over [1, 2^31), S's misses inside R's span."""
    import torch
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import radix as X
    from hwbloomradixjoin_tpu_torch.tools import validate_fullrange as VF

    chunk = B.CHUNK_ROWS * 128
    rk, sk = VF.build_inrange_workload(2 * chunk - 3000, 4 * chunk - 5000,
                                       0.3, seed=int(rng.integers(1 << 30)))
    lo, hi = int(rk.min()), int(rk.max())
    pb, shift, slr = B.plan_geometry(lo, hi)
    rb, rshift, rslr = B.plan_build_geometry(lo, hi, pb, shift, slr)
    if (pb, shift, slr) != VF.FULL_SPAN_GEOMETRY or X.pad_cat_safe(lo, hi) \
            or (rb, rshift, rslr) != (pb, shift, slr):
        raise AssertionError(f"full span: geometry {(pb, shift, slr)}")
    r_in = X._chunk_pad(rk, 2 * chunk, dev)
    s_in = X._chunk_pad(sk, 4 * chunk, dev)
    rgeom = X.RadixGeom(chunk_rows=B.CHUNK_ROWS, part_bits=rb, lo=lo, hi=hi,
                        shift=rshift, pad_cat=True)
    sgeom = X.RadixGeom(chunk_rows=B.CHUNK_ROWS, part_bits=pb, lo=lo, hi=hi,
                        shift=shift)
    for keys, geom in ((r_in, rgeom), (s_in, sgeom)):
        record(err, "partition", X.partition_pass(keys, geom),
               X.partition_pass_plain(keys, geom))
    r_part, r_starts = X.partition_pass(r_in, rgeom)
    split = B.build_split(r_part, r_starts, rshift, rb)
    bm = B.bitmap_build(r_part, lo, hi, rb, rshift, rslr, r_starts)
    record(err, "bitmap_build", bm,
           B.build_bitmap(r_part, lo, hi, rb, rshift, rslr))
    s_part, s_starts = X.partition_pass(s_in, sgeom)
    pclass = B.probe_split(s_part, s_starts, shift, pb)
    got = B.bitmap_probe_count(bm, s_part, lo, shift, pb, slr, s_starts)
    record(err, "bitmap_probe", got,
           B.bitmap_probe_count_plain(bm, s_part, lo, shift, pb, slr))
    truth = VF.host_count(rk, sk)
    if int(got) != truth:
        raise AssertionError(f"full span probe {int(got)} != host {truth}")
    del bm
    torch.cuda.empty_cache()
    print(f"kernel vs twin: bit-exact partition, build and probe at the "
          f"full span's {(pb, shift, slr)}, R's PAD category, "
          f"{r_in.numel() // chunk} + {s_in.numel() // chunk} chunks; build "
          f"{'flat' if split is None else f'staged nb={split.nb}'}, probe "
          f"{'flat' if pclass is None else f'staged {pclass.ctas} CTAs'}; "
          f"count {truth} = host", flush=True)


def check_build(label, plan, err) -> None:
    """The bitmap build of a planned join's R partition (the main path's
    full shape) against its twin, bit for bit."""
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import multipass as M

    join = getattr(plan, "join", plan)
    m = join._intermediates()
    if isinstance(join, M.TwoPassPlan):
        geo = (join.part_bits, join.shift, join.sl_rows)
    else:
        geo = (join.rgeom.part_bits, join.rgeom.shift, join.r_sl_rows)
    args = (m["r_part"], join.lo, join.hi, *geo)
    record(err, "bitmap_build", B.bitmap_build(*args, m["r_starts"]),
           B.build_bitmap(*args))
    print(f"{label}: bitmap build at {geo} over {m['r_part'].numel()} keys "
          f"bit-exact against the twin", flush=True)


def compare_table_kernels(dev, rng, err) -> None:
    """Phase 3, count-table kernels: partition_kv, table_build and
    table_probe (with and without S payloads) against their twins at
    workload B's count geometry, and the probe against the port's ref_join."""
    import torch
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import prho_join as P
    from hwbloomradixjoin_tpu_torch.ops import radix as X

    lo, hi = 1, B_SIZE
    pb, shift, slr = P.plan_geometry_counts(lo, hi)
    if (pb, shift, slr) != (13, 14, 128):
        raise AssertionError(f"workload B count geometry {(pb, shift, slr)}")
    chunk = B.CHUNK_ROWS * 128
    n = 4 * chunk
    # R: keys drawn with replacement (duplicates), 3000 copies of hi in one
    # slot, a PAD tail after padding; S: hits, in-range misses, keys above
    # hi inside the last bucket and past it, keys below lo, PAD
    rk = rng.integers(lo, hi + 1, n - 5000)
    rk[:3000] = hi
    rk = rk.astype(np.int32)
    rp = rng.integers(-2**31, 2**31, len(rk), dtype=np.int64).astype(np.int32)
    sk = rng.choice(rk, n).astype(np.int64)
    u = rng.random(n)
    for frac, a, b in ((0.3, lo, hi + 1), (0.2, hi + 1, lo + (1 << 27)),
                       (0.1, lo + (1 << 27), 2**31), (0.05, -2**31 + 1, lo)):
        sk[u < frac] = rng.integers(a, b, int((u < frac).sum()))
    sk[u > 0.97] = PAD_KEY
    sk = sk.astype(np.int32)
    sp = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    geom = X.RadixGeom(chunk_rows=B.CHUNK_ROWS, part_bits=pb, lo=lo, hi=hi,
                       shift=shift)
    r_in, rp_in = X._chunk_pad(rk, chunk, dev), X._chunk_pad(rp, chunk, dev)
    s_in, sp_in = torch.from_numpy(sk).to(dev), torch.from_numpy(sp).to(dev)
    for keys, pays in ((r_in, rp_in), (s_in, sp_in)):
        record(err, "partition_kv", X.partition_pass_kv(keys, pays, geom),
               X.partition_pass_kv_plain(keys, pays, geom))
        record(err, "partition", X.partition_pass(keys, geom),   # PRH's S
               X.partition_pass_plain(keys, geom))
    r_part = X.partition_pass_kv(r_in, rp_in, geom)
    s_part = X.partition_pass_kv(s_in, sp_in, geom)
    tb_args = (r_part[0], r_part[1], lo, hi, pb, shift, slr)
    tables = P.table_build(*tb_args, r_part[2])
    record(err, "table_build", tables, P.build_tables(*tb_args))
    sums = {}
    for with_sp in (True, False):
        args = (*tables, s_part[0], s_part[1] if with_sp else None, lo, shift,
                pb, slr)
        sums[with_sp] = P.probe_count_sums(*args, s_part[2])
        record(err, "table_probe", sums[with_sp],
               P.probe_count_sums_plain(*args))
    c, r, s = native.ref_join(rk, rp, sk, sp)
    truth = [c, r % 2**32, s % 2**32]
    if sums[True].tolist() != truth or sums[False].tolist() != truth[:2] + [0]:
        raise AssertionError(f"probe {sums[True].tolist()} / "
                             f"{sums[False].tolist()} != ref_join {truth}")
    print(f"kernel vs twin: bit-exact at count geometry {(pb, shift, slr)}, "
          f"4 chunks of {chunk} keys, max multiplicity "
          f"{int(tables[0].max())}, probe (count, r_sum, s_sum) {truth}",
          flush=True)


def survivors(keys) -> np.ndarray:
    """The sorted non-PAD keys of a pruned stream (its survivor multiset)."""
    keys = keys.reshape(-1)
    return np.sort(keys[keys != PAD_KEY].cpu().numpy())


def compare_bloom_kernels(dev, rng, err) -> None:
    """Phase 3d: the hash-mode partition, pass 2 in both modes and the
    bloom probe against their twins on 4 chunks; the probe's survivors
    against the plain prune on the card and the reference filter."""
    import torch
    from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                                   RadixConfig)
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.models import bloom_join
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import bloom
    from hwbloomradixjoin_tpu_torch.ops import bloom_pallas as BP
    from hwbloomradixjoin_tpu_torch.ops import multipass as M
    from hwbloomradixjoin_tpu_torch.ops import radix as X

    chunk_rows = B.CHUNK_ROWS
    n = 4 * chunk_rows * 128
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 30, k=1, B=512)
    part_bits, hash_bits = BP.geometry_raw(args)
    b1 = BP.MAX_PART_BITS
    # S: in-range keys of the 16M range test, negatives, keys at or above
    # 2^31 - 2^20, PAD; R (the filter's keys): a third of S's plus others
    u = rng.random(n)
    sk = rng.integers(1, R_SIZE + 1, n)
    sk[u < 0.3] = rng.integers(R_SIZE + 1, 1 << 24, int((u < 0.3).sum()))
    sk[u < 0.15] = rng.integers(2**31 - 2**20, 2**31, int((u < 0.15).sum()))
    sk[u < 0.08] = rng.integers(-2**31 + 1, 0, int((u < 0.08).sum()))
    sk[u > 0.97] = PAD_KEY
    sk = sk.astype(np.int32)
    rk = np.concatenate([sk[(sk != PAD_KEY) & (u < 0.6) & (u > 0.3)],
                         rng.integers(-2**31 + 1, 2**31, 100_000)
                         .astype(np.int32)])
    s_in = torch.from_numpy(sk).to(dev)
    hgeom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=b1,
                        hash_seed=args.seed, hash_bits=hash_bits)
    record(err, "partition_hash", X.partition_pass(s_in, hgeom),
           X.partition_pass_plain(s_in, hgeom))
    # pass 2, range mode: the 4d geometry, 12 bits over [1, 16M]
    pb, shift, _ = B.plan_geometry(1, R_SIZE, 12)
    rb1, rb2 = RadixConfig(passes=2).split_bits(pb)
    rgeom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=rb1, lo=1,
                        hi=R_SIZE, shift=shift + rb2)
    s1, st1 = X.partition_pass(s_in, rgeom)
    p2 = M.plan_pass2(s1, st1, rb1, rb2, chunk_rows, M.MAX_RANGE_CHUNKS,
                      lo=1, hi=R_SIZE, shift1=shift + rb2, shift2=shift)
    ranged = M.pass2_partition(s1, st1, p2)
    record(err, "pass2_partition", ranged,
           M.pass2_partition_plain(s1, st1, p2))
    # the bitmap probe over range regions, against a bitmap of every other
    # in-range S key built by the twin: at 4d's geometry (512-byte live
    # slices: the flat class), then at 3 + 3 bits over 16 chunks (32 KiB
    # slices: staged over regions)
    sk16 = np.concatenate([sk] * 4)
    for keys, c1, c2, staged in ((sk, rb1, rb2, False), (sk16, 3, 3, True)):
        bits, sh = c1 + c2, 24 - c1 - c2
        s1, st1 = X.partition_pass(
            torch.from_numpy(keys).to(dev),
            X.RadixGeom(chunk_rows=chunk_rows, part_bits=c1, lo=1, hi=R_SIZE,
                        shift=sh + c2))
        g2 = M.plan_pass2(s1, st1, c1, c2, chunk_rows, M.MAX_RANGE_CHUNKS,
                          lo=1, hi=R_SIZE, shift1=sh + c2, shift2=sh)
        regs = M.pass2_partition(s1, st1, g2)
        record(err, "pass2_partition", regs,
               M.pass2_partition_plain(s1, st1, g2))
        live = keys[(keys >= 1) & (keys <= R_SIZE)]
        slr = B.plan_geometry(1, R_SIZE, bits)[2]
        bm = B.build_bitmap(torch.from_numpy(live[::2]).to(dev), 1, R_SIZE,
                            bits, sh, slr)
        probe = (bm, regs[0], 1, sh, bits, slr)
        if (B.probe_split(regs[0], regs[1], sh, bits, c2) is not None) \
                != staged:
            raise AssertionError(f"the region probe at {c1} + {c2} bits took "
                                 f"the wrong class")
        got = B.bitmap_probe_count(*probe, regs[1], seg_bits=c2)
        record(err, "bitmap_probe", got, B.bitmap_probe_count_plain(*probe))
        if int(got) != int(np.isin(live, live[::2]).sum()):
            raise AssertionError(f"region probe count {int(got)}")
    # pass 2, hash mode: the flagship's 10 + 3 bits, as the prune plans it
    s1, st1 = X.partition_pass(s_in, hgeom)
    h2 = M.plan_pass2(s1, st1, b1, part_bits - b1, chunk_rows, None,
                      hash_seed=args.seed, hash_bits=hash_bits)
    regions = M.pass2_partition(s1, st1, h2)
    record(err, "pass2_partition_hash", regions,
           M.pass2_partition_plain(s1, st1, h2))
    # the bloom probe in every class: staged over the hash regions (the
    # flagship's), staged over pass 1's chunks (128 KiB slices: a skewed
    # S's), flat without starts, then staged over 4e's one-pass chunks; at
    # m = 2^30 with k = 1, 2 and 4 bits a key in its 512-bit block, each
    # k's survivors the plain prune's and the reference filter's
    b2 = part_bits - b1
    classes = {"regions": (regions[0], dict(starts=regions[1],
                                            part_bits=part_bits, seg_bits=b2)),
               "chunks": (s1, dict(starts=st1, part_bits=b1)),
               "flat": (regions[0], {})}
    kept = {}
    for k in BLOOM_KS:
        args_k = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 30, k=k,
                           B=512)
        words = bloom.build_bitmap(torch.from_numpy(rk).to(dev), args_k)
        for name, (keys, kw) in classes.items():
            staged = BP.probe_split(keys.reshape(-1), args_k,
                                    **kw) is not None
            if staged != (name != "flat"):
                raise AssertionError(f"bloom probe over {name}: staged "
                                     f"{staged}")
            got = BP.bloom_probe_prune(words, keys, args_k, **kw)
            record(err, "bloom_probe", got,
                   BP.bloom_probe_prune_plain(words, keys, args_k))
            if name == "regions":
                pruned = got
        mask, _ = bloom_join.bloom_prune(torch.from_numpy(rk).to(dev), s_in,
                                         args_k)
        want = np.sort(sk[native.ref_bloom("blocked", args_k.m, k, 512,
                                           args_k.seed, rk, sk)
                          & (sk != PAD_KEY)])
        keep = mask & (s_in != PAD_KEY)
        got = survivors(pruned[0])
        if not (np.array_equal(got, want)
                and np.array_equal(got, survivors(s_in[keep]))
                and int(pruned[1]) == len(want) == int(keep.sum())):
            raise AssertionError(f"bloom survivors at k={k}: kernel "
                                 f"{len(got)}, plain {int(keep.sum())}, "
                                 f"reference {len(want)}")
        kept[k] = len(want)
        del words
    args27 = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 27, k=1, B=512)
    g27 = X.RadixGeom(chunk_rows=chunk_rows, part_bits=10,
                      hash_seed=args27.seed, hash_bits=18)
    words27 = bloom.build_bitmap(torch.from_numpy(rk).to(dev), args27)
    h27, st27 = X.partition_pass(s_in, g27)
    record(err, "bloom_probe",
           BP.bloom_probe_prune(words27, h27, args27, starts=st27,
                                part_bits=10),
           BP.bloom_probe_prune_plain(words27, h27, args27))
    print(f"kernel vs twin: bit-exact hash partition {(b1, hash_bits)}, "
          f"pass 2 range ({rb1}+{rb2} bits, c1_rows "
          f"{p2.c1_rows}) and hash ({b1}+{part_bits - b1} bits, c1_rows "
          f"{h2.c1_rows}), the bitmap probe over range regions (flat, and "
          f"staged at 3 + 3 bits), bloom "
          f"probe m=2^30 B=512 (staged over regions and chunks, flat) and "
          f"m=2^27 (10 bits): survivors by k {kept} = plain prune = "
          f"reference filter", flush=True)


def edge_stream(rng, n, lo, hi):
    """Keys in [lo, hi], at lo - 1 and hi + 1, negative, above hi and PAD;
    payloads over all of int32, +-2^31 included, so sums wrap."""
    k = rng.integers(lo, hi + 1, n)
    u = rng.random(n)
    k[u < 0.3] = rng.integers(hi + 1, 2**31, int((u < 0.3).sum()))
    k[u < 0.1] = rng.integers(-2**31 + 1, 0, int((u < 0.1).sum()))
    k[(u > 0.90) & (u < 0.92)] = lo - 1
    k[(u > 0.92) & (u < 0.94)] = hi + 1
    k[u > 0.97] = PAD_KEY
    p = rng.integers(-2**31, 2**31, n, dtype=np.int64)
    p[u < 0.2] = 2**31 - 1
    p[u > 0.8] = -2**31
    return k.astype(np.int32), p.astype(np.int32)


def compare_new_kernels(dev, rng, err) -> None:
    """Phase 3e: the dense count, materialization and the gathered probe
    against their twins on 4 chunks, at the main paths' geometries (dense
    and materialize over [1, 16M]; the gathered probe at the JAX default
    geometry, 12 low bits, with a duplicate-heavy R and with one bucket
    holding one key past the capacity, which must report overflow)."""
    import torch
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import dense_join as D
    from hwbloomradixjoin_tpu_torch.ops import prho_join as P
    from hwbloomradixjoin_tpu_torch.ops import radix as X

    lo, hi = 1, R_SIZE
    n = 4 * B.CHUNK_ROWS * 128
    sk, sp = edge_stream(rng, n, lo, hi)
    k, p = torch.from_numpy(sk).to(dev), torch.from_numpy(sp).to(dev)
    for m in (n, n - 3):               # whole 16-byte groups and a tail
        got = D.dense_count_join(k[:m], p[:m], lo, hi)
        record(err, "dense_count", got,
               D.dense_count_join_plain(k[:m], p[:m], lo, hi))
        hit = (sk[:m] >= lo) & (sk[:m] <= hi)
        want = [int(hit.sum()), int(sp[:m][hit].astype(np.int64).sum()) % 2**32]
        if got.tolist() != want:
            raise AssertionError(f"dense {got.tolist()} != numpy {want}")
    # materialize: unique R (payloads with PAD among them), S with hits
    pb, shift, slr = P.plan_geometry_counts(lo, hi)
    geom = X.RadixGeom(chunk_rows=B.CHUNK_ROWS, part_bits=pb, lo=lo, hi=hi,
                       shift=shift)
    rk = rng.choice(np.arange(lo, hi + 1, dtype=np.int32), n - 999,
                    replace=False)
    rp = rng.integers(-2**31, 2**31, len(rk), dtype=np.int64).astype(np.int32)
    rp[::7] = PAD_KEY
    sk[: n // 3] = rng.choice(rk, n // 3)
    s_in, sp_in = torch.from_numpy(sk).to(dev), torch.from_numpy(sp).to(dev)
    r_part = X.partition_pass_kv(X._chunk_pad(rk, n, dev),
                                 X._chunk_pad(rp, n, dev), geom)
    tables = P.table_build(r_part[0], r_part[1], lo, hi, pb, shift, slr,
                           r_part[2])
    s_part = X.partition_pass_kv(s_in, sp_in, geom)
    args = (*tables, s_part[0], s_part[1], lo, shift, pb, slr)
    out = P.materialize_pairs(*args, s_part[2])
    record(err, "materialize", out, P.materialize_pairs_plain(*args))
    n_pairs = int(np.isin(sk, rk).sum())
    if int(out[3]) != n_pairs:
        raise AssertionError(f"materialize count {int(out[3])} != {n_pairs}")
    # gathered probe: duplicates (each key ~4 times), then a hot bucket
    ggeom = X.RadixGeom()
    rk = rng.integers(-R_SIZE // 8, R_SIZE // 8, n).astype(np.int32)
    sk = np.concatenate([rng.choice(rk, n // 2),
                         edge_stream(rng, n // 2, -R_SIZE // 8,
                                     R_SIZE // 8)[0]])
    hot = np.arange(X.R_CAP + 1, dtype=np.int64).astype(np.int32) * 4096
    # buckets 0-2 of R_CAP, 12,000 and 3,000 keys: every capacity class
    classes = np.concatenate([rk[rk % 4096 > 2], hot[:X.R_CAP],
                              hot[:12_000] + 1, hot[:3_000] + 2])
    results = []
    for r_keys in (rk, np.concatenate([rk[rk % 4096 != 0], hot]), classes):
        parts = []
        for keys in (r_keys, sk):
            parts += X.partition_pass(X._chunk_pad(keys, n, dev), ggeom)
        got = X.gathered_probe_count(*parts, ggeom)
        record(err, "gathered_probe", got,
               X.gathered_probe_count_plain(*parts, ggeom))
        results.append(got.tolist())
    truth = [int(native_count(rk, sk)), int(native_count(classes, sk))]
    if results[0] != [truth[0], 0] or results[1][1] != 1 \
            or results[2] != [truth[1], 0]:
        raise AssertionError(f"gathered probe {results}, want [{truth[0]}, "
                             f"0], an overflow and [{truth[1]}, 0]")
    print(f"kernel vs twin: bit-exact dense count, materialize at count "
          f"geometry {(pb, shift, slr)} ({n_pairs} pairs), gathered probe "
          f"{results[0]}, with a bucket of R_CAP + 1 keys {results[1]}, "
          f"with buckets of every capacity class {results[2]}", flush=True)


def native_count(rk, sk) -> int:
    """ref_join's match count (the port's native ground truth)."""
    from hwbloomradixjoin_tpu_torch.data import native
    return native.ref_join(rk, np.zeros_like(rk), sk, np.zeros_like(sk))[0]


def drive(algo, R, S, cfg, must, label, kind, bloom_args=None):
    """run_join with the launch counts reset just before and read just
    after; every kernel in `must` has to have launched.  Returns
    (result, stats, sums, launches)."""
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.models import run_join

    _build.reset_launches()
    res, st, sums = run_join(algo, R, S, cfg, bloom_args, inner_repeats=4)
    ran = dict(_build.LAUNCHES)
    missing = [k for k in must if ran[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    phases = " ".join(f"{k}={v / 1e3:.4f}ms" for k, v in st.phases.items())
    print(f"{label} on {kind}: tier={st.tier} count={res.count()} "
          f"sums={sums} s_after_filter={res.s_after_filter} "
          f"total={st.total_usec / 1e3:.4f}ms "
          f"ns/S-tuple={st.total_usec * 1e3 / S.capacity:.5f} "
          f"build={st.build_usec / 1e3:.4f}ms part={st.part_usec / 1e3:.4f}ms"
          f" probe={st.probe_usec / 1e3:.4f}ms {phases} launches={ran}",
          flush=True)
    return res, st, sums, ran


def add_launches(total: dict, ran: dict) -> None:
    for k in total:
        total[k] += ran[k]


def run_pro_path(dev, q, kind, launches):
    """Phase 4, one selectivity: PRO 16M ⋈ 128M on cuda_radix.  Returns a
    plan of the same inputs for kernel timing, R and S (S's payloads on the
    card too, for the dense and materializing phases)."""
    import torch
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join
    from hwbloomradixjoin_tpu_torch.types import Relation

    params = G.WorkloadParams(r_size=R_SIZE, s_size=S_SIZE, nthreads=8,
                              selectivity=q)
    rk, rp, sk, sp = G.build_workload(params)
    pad = (-len(sk)) % (bitmap_join.CHUNK_ROWS * 128)
    sk = np.concatenate([sk, np.full(pad, PAD_KEY, np.int32)])
    sp = np.concatenate([sp, np.zeros(pad, np.int32)])
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    S = Relation(key=torch.from_numpy(sk).to(dev),
                 payload=torch.from_numpy(sp).to(dev))
    must = ("partition", "bitmap_build", "bitmap_probe") if q == 1.0 \
        else ("compact",)
    res, st, _, ran = drive("PRO", R, S, EngineConfig(allow_dense=False),
                            must, f"PRO 16M x 128M q={q}", kind)
    expect = G.expected_uniform_match_count(S_SIZE, q)
    if st.tier != "cuda_radix":
        raise AssertionError(f"q={q}: tier {st.tier} != cuda_radix")
    if res.count() != expect:
        raise AssertionError(f"q={q}: count {res.count()} != {expect}")
    add_launches(launches, ran)
    return bitmap_join.plan_radix_join(R.key, S.key, 1, R_SIZE,
                                       device=dev), R, S


def run_two_pass(R, S, kind, launches, err):
    """Phase 4d: two-pass PRO 16M ⋈ 128M at q = 1 (6 + 6 bits).  Returns
    the two-pass plan of the same inputs for kernel timing."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.models import registry
    from hwbloomradixjoin_tpu_torch.ops import multipass

    cfg = EngineConfig(radix=RadixConfig(passes=2, num_radix_bits=12),
                       allow_dense=False)
    res, st, _, ran = drive(
        "PRO", R, S, cfg, ("partition", "pass2_partition", "bitmap_build",
                           "bitmap_probe"), "two-pass PRO 16M x 128M q=1",
        kind)
    expect = G.expected_uniform_match_count(S_SIZE, 1.0)
    if st.tier != "cuda_radix" or "s_pass2" not in st.phases:
        raise AssertionError(f"two-pass: tier {st.tier}, phases "
                             f"{list(st.phases)}")
    if res.count() != expect:
        raise AssertionError(f"two-pass: count {res.count()} != {expect}")
    add_launches(launches, ran)
    plan = registry.plan_kernel_join("cuda_radix", R, S, cfg,
                                     *registry.key_ranges(R))
    if not isinstance(plan, multipass.TwoPassPlan):
        raise AssertionError(f"two-pass: planned {type(plan).__name__}")
    print(f"two-pass plan: pass 2 {plan.pass2}", flush=True)
    check_build("two-pass PRO", plan, err)
    return plan


def run_bloom(R, S, s_size, q, args, must, label, kind, launches):
    """Phases 4e and 4f: PRO with a blocked filter.  The count must be the
    uniform workload's and S-tuples after filter the plain prune's on the
    same card (over S without its PAD tail).  Returns (stats, the
    kernel-tier plan of the same inputs or None)."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.models import bloom_join

    res, st, _, ran = drive("PRO", R, S, EngineConfig(allow_dense=False),
                            must, label, kind, bloom_args=args)
    expect = G.expected_uniform_match_count(s_size, q)
    _, n_plain = bloom_join.bloom_prune(R.key, S.key[:s_size], args)
    if st.tier != "cuda_radix" or res.count() != expect:
        raise AssertionError(f"{label}: tier {st.tier} count {res.count()} "
                             f"!= {expect}")
    if res.s_after_filter != int(n_plain) or st.s_after_filter != int(n_plain):
        raise AssertionError(f"{label}: s_after_filter {res.s_after_filter}"
                             f" != plain prune {int(n_plain)}")
    print(f"{label}: S-tuples after filter {res.s_after_filter} of {s_size} "
          f"= {100.0 * res.s_after_filter / s_size:.4f} % (the reference: "
          f"{REF_SURVIVOR_PCT} % at the flagship), equal to the plain prune",
          flush=True)
    add_launches(launches, ran)
    return st


def run_bpro(R, S, kind, launches, err):
    """Phase 4e: BPRO 16M ⋈ 128M at q = 0.01, blocked, k = 1, m = 2^27,
    B = 512 (one 10-bit hash pass).  Returns the filtered plan of the same
    inputs for kernel timing."""
    from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                                   EngineConfig)
    from hwbloomradixjoin_tpu_torch.models import registry
    from hwbloomradixjoin_tpu_torch.ops import bloom_pallas

    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 27, k=1, B=512)
    if bloom_pallas.geometry(args) != (10, 18):
        raise AssertionError("4e's filter is not the 1-pass 10-bit geometry")
    run_bloom(R, S, S_SIZE, 0.01, args,
              ("bloom_build", "partition_hash", "bloom_probe", "compact",
               "partition", "bitmap_build", "bitmap_probe"),
              "BPRO 16M x 128M q=0.01 blocked k=1 m=2^27 B=512", kind,
              launches)
    plan = registry.plan_kernel_join("cuda_radix", R, S, EngineConfig(
        allow_dense=False), *registry.key_ranges(R), bloom_args=args)
    check_build("BPRO", plan, err)
    return plan


def run_flagship(dev, kind, launches, err):
    """Phase 4f: BRJ 128M ⋈ 1.024B at q = 0.01, blocked, k = 1, m = 2^30,
    B = 512: the two-pass prune.  S's keys only are on the card.  Returns
    the probes' class cells at the flagship and the filter build's times
    there: (kernel ms, twin ms, bound ms, bound_by, sector bound ms)."""
    import torch
    from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                                   EngineConfig)
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.models import registry
    from hwbloomradixjoin_tpu_torch.ops import run_split
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join, bloom, bloom_pallas
    from hwbloomradixjoin_tpu_torch.types import Relation
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    t0 = time.perf_counter()
    params = G.WorkloadParams(r_size=FLAG_R_SIZE, s_size=FLAG_S_SIZE,
                              nthreads=8, selectivity=0.01)
    rk, rp, sk, _ = G.build_workload(params)
    pad = (-len(sk)) % (bitmap_join.CHUNK_ROWS * 128)
    sk = np.concatenate([sk, np.full(pad, PAD_KEY, np.int32)])
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    S = Relation(key=torch.from_numpy(sk).to(dev),
                 payload=torch.zeros(1, dtype=torch.int32, device=dev))
    del rk, rp, sk
    print(f"flagship data: {time.perf_counter() - t0:.1f}s", flush=True)
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 30, k=1, B=512)
    if bloom_pallas.geometry(args) is not None \
            or bloom_pallas.geometry_raw(args) != (13, 21):
        raise AssertionError("the flagship filter is not the 2-pass 13-bit "
                             "geometry")
    st = run_bloom(R, S, FLAG_S_SIZE, 0.01, args,
                   ("bloom_build", "partition_hash", "pass2_partition_hash",
                    "bloom_probe", "compact", "partition", "bitmap_build",
                    "bitmap_probe"),
                   "BRJ 128M x 1.024B q=0.01 blocked k=1 m=2^30 B=512", kind,
                   launches)
    # the open question of PERF.md: the same probe kernel over S as
    # generated, with no hash partition ahead of it (one random 32-byte
    # sector of the 128 MiB filter a key)
    # the filter build at this shape: kernel and twin, each against the other
    # and the reference filter bit for bit, beside the streaming bound (the
    # keys read and the words written once) and the sector bound (a random
    # 32-byte sector read and written back a key)
    build_ms = time_usec(lambda: bloom.build_bitmap(R.key, args), dev) / 1e3
    plain_ms = time_usec(lambda: bloom.build_bitmap_plain(R.key, args),
                         dev) / 1e3
    words = bloom.build_bitmap(R.key, args)
    record(err, "bloom_build", words, bloom.build_bitmap_plain(R.key, args))
    r_host = R.key.cpu().numpy()
    _, ref = native.ref_bloom("blocked", args.m, args.k, args.B, args.seed,
                              r_host, r_host[:1], want_bitmap=True)
    if not np.array_equal(words.cpu().numpy().view(np.uint8), ref):
        raise AssertionError("the flagship filter differs from "
                             "native.ref_bloom's")
    n_r = R.key.numel()
    t_bytes = (4 * n_r + args.m // 8) / HBM_BYTES_PER_S * 1e3
    t_ops = n_r * OPS_PER_ELEM["bloom_build"] / INT32_OPS_PER_S * 1e3
    sector = 2 * 32 * n_r / HBM_BYTES_PER_S * 1e3
    build = (build_ms, plain_ms, max(t_bytes, t_ops),
             "bytes" if t_bytes >= t_ops else "operations", sector)
    print(f"bloom_build at the flagship ({n_r} keys, m=2^30, B=512, k=1): "
          f"kernel {build_ms:.4f} ms, twin {plain_ms:.4f} ms, streaming "
          f"bound {t_bytes:.4f} ms, operations bound {t_ops:.4f} ms, sector "
          f"bound {sector:.4f} ms; equal to the twin and native.ref_bloom",
          flush=True)
    direct = time_usec(lambda: bloom_pallas.bloom_probe_prune(words, S.key,
                                                              args), dev)
    _, n = bloom_pallas.bloom_probe_prune(words, S.key, args)
    if int(n) != st.s_after_filter:
        raise AssertionError(f"direct probe kept {int(n)}")
    print(f"flagship filter probe without the hash partition: "
          f"{direct / 1e3:.4f} ms over {S.key.numel()} keys, against "
          f"{(st.phases['bloom_partition'] + st.phases['bloom_probe']) / 1e3:.4f}"
          f" ms for the two hash passes and the probe", flush=True)
    del words
    plan = registry.plan_kernel_join("cuda_radix", R, S, EngineConfig(
        allow_dense=False), *registry.key_ranges(R), bloom_args=args)
    check_build("BRJ 128M x 1.024B", plan, err)
    return class_cells("flagship", plan, run_split.card_sms(dev)), build


def validated(label, R, S, n_s, expected, args, must, kind, launches,
              geometry=None):
    """One of the validation tools' joins (validate_fullrange's
    validate_join: the count, the tier, the geometry if given, S-tuples
    after filter against the plain prune and the survivor theory), with
    the launch counts reset just before run_join and read as it returns;
    every kernel in `must` has to have launched."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.tools import validate_fullrange as VF

    ran = {}
    _build.reset_launches()
    ok, st, line = VF.validate_join(
        label, R, S, n_s, expected, EngineConfig(allow_dense=False), args,
        geometry, inner_repeats=4,
        on_joined=lambda: ran.update(_build.LAUNCHES))
    print(f"{line} launches={ran}", flush=True)
    if not ok:
        raise AssertionError(line)
    missing = [k for k in must if ran[k] == 0]
    if missing:
        raise AssertionError(f"{label} on {kind}: kernels never launched: "
                             f"{missing}")
    add_launches(launches, ran)
    return st


def run_validations(dev, R, S, kind, launches):
    """Phase 4p: the validation tools' joins at full size.  validate_
    fullrange: PRO and BPRO (blocked, m = 2^30, k = 4, B = 512) over a
    sparse unique R of 16M keys over [1, 2^31) and 128M S keys whose misses
    lie inside R's span, plan (13, 18, 64) with R's PAD category, counted
    against the host; validate_bloom: BPRO over PRO q = 0.01's relations
    (R, S) at k = 2 and 4 (m = 2^30).  Each count exact, S-tuples after
    filter the plain prune's, the survivors within 20 % of theory."""
    import torch
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.tools import validate_fullrange as VF

    part = ("partition", "bitmap_build", "bitmap_probe")
    prune = ("partition_hash", "pass2_partition_hash", "bloom_probe")
    t0 = time.perf_counter()
    rk, sk = VF.build_inrange_workload(R_SIZE, S_SIZE, 0.01)
    want = VF.host_count(rk, sk)
    fr, fs = VF.relations(rk, sk, dev)
    del rk, sk
    gen_s = time.perf_counter() - t0
    print(f"full span: host generation and count {gen_s:.1f}s, expect "
          f"{want} of {S_SIZE}", flush=True)
    validated("full-span PRO 16M x 128M", fr, fs, S_SIZE, want, None, part,
              kind, launches, VF.FULL_SPAN_GEOMETRY)
    validated("full-span BPRO blocked m=2^30 k=4 B=512", fr, fs, S_SIZE,
              want, VF.blocked(1 << 30, 4), part + prune, kind, launches,
              VF.FULL_SPAN_GEOMETRY)
    del fr, fs
    torch.cuda.empty_cache()
    want = G.expected_uniform_match_count(S_SIZE, 0.01)
    for k in BLOOM_KS[1:]:
        validated(f"BPRO 16M x 128M q=0.01 blocked m=2^30 k={k} B=512", R, S,
                  S_SIZE, want, VF.blocked(1 << 30, k), part + prune, kind,
                  launches)


def class_cells(label, plan, sms) -> list:
    """The class each kernel of a planned join that walks runs takes (the
    bloom probe of its prune, if any, the bitmap build and the bitmap
    probe), its split, CTAs and resident CTAs an SM on this card: one cell
    each."""
    import torch
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import bloom_pallas as BP
    from hwbloomradixjoin_tpu_torch.ops import multipass as M

    def cell(name, split, query, *shape):
        with torch.cuda.device(0):
            per_sm = query(0 if split is None else split.nb, *shape)
        if split is None:
            return f"{label} {name}: flat, {per_sm} CTAs an SM"
        return (f"{label} {name}: staged over "
                f"{'regions' if split.regions else 'chunks'} (nb={split.nb}"
                f" span={split.span} group={split.group}), {split.ctas} "
                f"CTAs, {per_sm} an SM")

    cells = []
    prune = getattr(plan, "prune", None)
    if prune is not None:
        # the partition's sizes: pass 1's chunks, or pass 2's regions
        g, p2 = prune.pgeom, prune.pass2
        if p2 is None:
            n, seg_bits, bits = prune.sk_in.numel(), g.part_bits, g.part_bits
            nstarts = n // (g.chunk_rows * 128) * g.cat_rows * 128
        else:
            n = (1 << p2.b1) * p2.cap_rows * 128
            seg_bits, bits = p2.b2, p2.b1 + p2.b2
            nstarts = (1 << p2.b1) * p2.cat2_rows * 128
        keys = torch.empty(n, dtype=torch.int32, device="meta")
        starts = torch.empty(nstarts, dtype=torch.int32, device="meta")
        split = BP.probe_split(keys, prune.args, starts, bits, seg_bits, sms)
        cells.append(cell("bloom_probe", split,
                          _build.lib().hbrj_bloom_probe_per_sm,
                          BP.slice_words(prune.args, bits), prune.args.k))
    join = getattr(plan, "join", plan)
    m = join._intermediates()
    if isinstance(join, M.TwoPassPlan):
        rbits, rshift = join.part_bits, join.shift
    else:
        rbits, rshift = join.rgeom.part_bits, join.rgeom.shift
    split = B.build_split(m["r_part"], m["r_starts"], rshift, rbits, sms)
    with torch.cuda.device(0):
        per_sm = _build.lib().hbrj_bitmap_build_per_sm(
            0 if split is None else split.nb, B.live_words(rshift),
            0 if split is None else split.nseg)
    cells.append(f"{label} bitmap_build: flat, {per_sm} CTAs an SM"
                 if split is None else
                 f"{label} bitmap_build: staged, clusters of {split.share} "
                 f"over ranges (nb={split.nb}), "
                 f"{split.ctas} CTAs, {per_sm} an SM")
    if isinstance(join, M.TwoPassPlan):
        shift = join.shift
        split = B.probe_split(*m["s2"], shift, join.part_bits, join.pass2.b2,
                              sms)
    else:
        shift = join.sgeom.shift
        split = B.probe_split(*m["s_part"], shift, join.sgeom.part_bits,
                              None, sms)
    cells.append(cell("bitmap_probe", split,
                      _build.lib().hbrj_bitmap_probe_per_sm,
                      B.live_words(shift)))
    return cells


def run_dense(R, S, q, kind, launches):
    """Phase 4g: the default config over the generator's dense PK (no
    allow_dense=False): the dense tier, the exact count and the ht tier's
    S checksum on the card."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G

    res, st, sums, ran = drive("PRO", R, S, EngineConfig(), ("dense_count",),
                               f"PRO 16M x 128M q={q}, EngineConfig()", kind)
    _, ref_sums = plain_reference("PRO", R, S, f"dense q={q}")
    expect = G.expected_uniform_match_count(S_SIZE, q)
    if st.tier != "dense" or res.count() != expect \
            or tuple(sums) != (0, ref_sums[1]):
        raise AssertionError(f"dense q={q}: tier {st.tier} count "
                             f"{res.count()} sums {sums}, want {expect} "
                             f"(0, {ref_sums[1]})")
    add_launches(launches, ran)


def pair_order(r_pay, s_pay):
    """The pairs sorted by (s_pay, r_pay): equal iff the multisets are."""
    import torch
    return torch.sort((s_pay.long() << 32) | (r_pay.long() & 0xFFFFFFFF)
                      ).values


def run_materialize(R, S, q, kind, launches):
    """Phase 4h: EngineConfig(materialize=True): the cuda_materialize tier,
    the exact count, and the pair multiset of the portable
    sort_scan_materialize on the card.  Returns (the plan of the same inputs
    for kernel timing at q = 1, else None; the materialize phase's ms)."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import prho_join, xla_join

    res, st, _, ran = drive(
        "PRO", R, S, EngineConfig(materialize=True),
        ("partition_kv", "table_build", "materialize"),
        f"materialize 16M x 128M q={q}", kind)
    expect = G.expected_uniform_match_count(S_SIZE, q)
    if st.tier != "cuda_materialize" or res.count() != expect \
            or res.r_payload.numel() != expect:
        raise AssertionError(f"materialize q={q}: tier {st.tier} count "
                             f"{res.count()} pairs {res.r_payload.numel()}"
                             f" != {expect}")
    t0 = time.perf_counter()
    count, out_r, out_s, _ = xla_join.sort_scan_materialize(
        R.key, R.payload, S.key, S.payload)
    n = int(count)
    same = n == expect and bool((pair_order(res.r_payload, res.s_payload)
                                 == pair_order(out_r[:n], out_s[:n])).all())
    if not same:
        raise AssertionError(f"materialize q={q}: pairs differ from the "
                             f"portable tier's ({n})")
    print(f"materialize q={q}: {expect} pairs = sort_scan_materialize's on "
          f"the card ({time.perf_counter() - t0:.1f}s)", flush=True)
    add_launches(launches, ran)
    del res, out_r, out_s
    ms = st.phases["materialize"] / 1e3
    if q != 1.0:
        return None, ms
    return prho_join.plan_materialize_join(R.key, R.payload, S.key,
                                           S.payload, 1, R_SIZE,
                                           device=R.device), ms


def run_radix_count(R, S, kind, launches):
    """Phase 4i: the general radix count join (12 low bits, the gathered
    probe) at q = 1.  Returns its partitions for kernel timing."""
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.ops import radix as X
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    _build.reset_launches()
    t0 = time.perf_counter()
    count, overflow = X.radix_join_count(R.key, S.key, device=R.device)
    wall = time.perf_counter() - t0
    ran = dict(_build.LAUNCHES)
    missing = [k for k in ("partition", "gathered_probe") if ran[k] == 0]
    expect = G.expected_uniform_match_count(S_SIZE, 1.0)
    if missing or count != expect or overflow:
        raise AssertionError(f"radix_join_count: {count} overflow {overflow}"
                             f" (want {expect}), never launched: {missing}")
    add_launches(launches, ran)
    geom = X.RadixGeom()
    r_in = X._chunk_pad(R.key, geom.chunk_rows * 128, R.device)
    parts = (*X.partition_pass(r_in, geom), *X.partition_pass(S.key, geom))
    # the whole join (its result read back) and its three kernels alone
    total = time_usec(lambda: X.radix_join_count(R.key, S.key,
                                                 device=R.device), R.device)
    phases = {"r_partition": time_usec(lambda: X.partition_pass(r_in, geom),
                                       R.device),
              "s_partition": time_usec(lambda: X.partition_pass(S.key, geom),
                                       R.device),
              "probe": time_usec(lambda: X.gathered_probe_count(*parts, geom),
                                 R.device)}
    print(f"radix_join_count 16M x 128M q=1 on {kind}: count={count} "
          f"overflow={overflow} first call {wall * 1e3:.1f}ms, "
          f"total={total / 1e3:.4f}ms ns/S-tuple={total * 1e3 / S_SIZE:.5f} "
          + " ".join(f"{k}={v / 1e3:.4f}ms" for k, v in phases.items())
          + f" launches={ran}", flush=True)
    gathered_probe_class(parts[1], geom)
    return parts


def gathered_probe_class(r_starts, geom) -> None:
    """One line: the capacity class the gathered probe gives 4i's largest R
    bucket, its table's slots and its CTAs an SM on this card."""
    import ctypes
    import torch
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.ops import radix as X

    F = 1 << geom.part_bits
    st = r_starts.reshape(-1, geom.cat_rows * 128)[:, :F + 1].long()
    sizes = (st[:, 1:] - st[:, :-1]).sum(0)
    slots, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(r_starts.device):
        k = _build.lib().hbrj_gathered_probe_class(
            int(sizes.max()), X.R_CAP, ctypes.byref(slots),
            ctypes.byref(per_sm))
    if k < 0:
        raise AssertionError(f"gathered probe class query gave {k}")
    print(f"gathered probe at 4i: R buckets of {int(sizes.min())} to "
          f"{int(sizes.max())} keys, class {k}: {slots.value} table slots "
          f"({slots.value * 8} bytes), {per_sm.value} CTAs an SM", flush=True)


def plain_reference(algo, R, S, label):
    """The ht tier (plain torch, an independent implementation) on the card."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig
    from hwbloomradixjoin_tpu_torch.models import run_join

    cfg = EngineConfig(radix=RadixConfig(use_kernels=False),
                       allow_dense=False)
    res, st, sums = run_join(algo, R, S, cfg)
    if st.tier != "ht":
        raise AssertionError(f"{label}: reference tier {st.tier} != ht")
    print(f"{label}: ht reference count={res.count()} sums={sums} "
          f"total={st.total_usec / 1e3:.4f}ms", flush=True)
    return res.count(), sums


def run_workload_b(dev, kind, launches):
    """Phase 4b: PRHO, PRH and NPO on workload B against the ht tier.
    Returns the PRHO plan of the same inputs for kernel timing, R, S, the
    ht tier's sums and PRHO's probe phase in ms."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import prho_join
    from hwbloomradixjoin_tpu_torch.types import Relation

    params = G.WorkloadParams(r_size=B_SIZE, s_size=B_SIZE, nthreads=8)
    rk, rp, sk, sp = G.build_workload(params)
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    S = Relation.from_numpy(sk, sp, device=dev)
    del rk, rp, sk, sp
    expect = G.expected_uniform_match_count(B_SIZE, 1.0)
    ref_count, ref_sums = plain_reference("PRHO", R, S, "workload B")
    if ref_count != expect:
        raise AssertionError(f"workload B: ht count {ref_count} != {expect}")
    kv = ("partition_kv", "table_build", "table_probe")
    for algo, tier, must, want in (
            ("PRHO", "cuda_prho", kv, ref_sums),
            ("PRH", "cuda_prh", kv + ("partition",), (ref_sums[0], 0)),
            ("NPO", "cuda_npo", kv, ref_sums)):
        res, st, sums, ran = drive(algo, R, S, EngineConfig(allow_dense=False),
                                   must, f"{algo} workload B", kind)
        if st.tier != tier:
            raise AssertionError(f"{algo}: tier {st.tier} != {tier}")
        if res.count() != expect or tuple(sums) != tuple(want):
            raise AssertionError(f"{algo}: count {res.count()} sums {sums} "
                                 f"!= {expect} {want}")
        add_launches(launches, ran)
        if algo == "PRHO":
            probe_ms = st.phases["probe"] / 1e3
    plan = prho_join.plan_prho_join(R.key, R.payload, S.key, S.payload, 1,
                                    B_SIZE, device=dev)
    return plan, R, S, ref_sums, probe_ms


def run_wide_bits(R, S, ref_sums, kind, launches):
    """Phase 4j: workload B under PRHO with RadixConfig(num_radix_bits=b)
    for b = 14..17, figure 9's axis past the port's former 13-bit limit:
    tier cuda_prho, the kernels launched, 4b's count and checksums.
    Returns bits -> the probe phase in ms."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig, RadixConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G

    expect = G.expected_uniform_match_count(B_SIZE, 1.0)
    probe_ms = {}
    for bits in WIDE_BITS:
        cfg = EngineConfig(radix=RadixConfig(num_radix_bits=bits),
                           allow_dense=False)
        res, st, sums, ran = drive("PRHO", R, S, cfg,
                                   ("partition_kv", "table_build",
                                    "table_probe"),
                                   f"PRHO workload B num_radix_bits={bits}",
                                   kind)
        if st.tier != "cuda_prho" or res.count() != expect \
                or tuple(sums) != tuple(ref_sums):
            raise AssertionError(f"{bits} bits: tier {st.tier} count "
                                 f"{res.count()} sums {sums}, want {expect} "
                                 f"{ref_sums}")
        add_launches(launches, ran)
        probe_ms[bits] = st.phases["probe"] / 1e3
    return probe_ms


def partition_widths(dev, keys, pays) -> None:
    """One line: the partition's ms and ns a key, keys only and with
    payloads, at each width of PART_WIDTHS over the same keys (range mode
    over workload B's [1, 128M])."""
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import radix as X
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    n = keys.numel()
    cells = []
    for bits in PART_WIDTHS:
        geom = X.RadixGeom(chunk_rows=B.CHUNK_ROWS, part_bits=bits, lo=1,
                           hi=B_SIZE, shift=27 - bits)
        k_ms = time_usec(lambda: X.partition_pass(keys, geom), dev) / 1e3
        kv_ms = time_usec(lambda: X.partition_pass_kv(keys, pays, geom),
                          dev) / 1e3
        cells.append(f"{bits} bits {k_ms:.4f} ms {k_ms * 1e6 / n:.5f} ns/key"
                     f" (kv {kv_ms:.4f} ms {kv_ms * 1e6 / n:.5f} ns/key)")
    print(f"partition widths over {n} keys: " + "; ".join(cells), flush=True)


def pass2_widths(dev, two_pass, err) -> None:
    """One line: pass 2's ms and ns a key in range mode over 4d's S (its
    pass-1 output, b1 = 6) at each b2 of PASS2_WIDTHS, each output equal to
    the twin's."""
    from hwbloomradixjoin_tpu_torch.ops import multipass as M
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    s1 = two_pass.s_partition()
    g = two_pass.pass2
    n = s1[0].numel()
    cells = []
    for b2 in PASS2_WIDTHS:
        geom = M.plan_pass2(*s1, g.b1, b2, g.chunk_rows, M.MAX_RANGE_CHUNKS,
                            lo=g.lo, hi=g.hi, shift1=g.shift1,
                            shift2=g.shift1 - b2)
        ms = time_usec(lambda: M.pass2_partition(*s1, geom), dev) / 1e3
        record(err, "pass2_partition", M.pass2_partition(*s1, geom),
               M.pass2_partition_plain(*s1, geom))
        cells.append(f"b2={b2} {ms:.4f} ms {ms * 1e6 / n:.5f} ns/key")
    print(f"pass 2 widths (range mode, b1={g.b1}, {n} keys of 4d's S): "
          + "; ".join(cells), flush=True)


def run_nonunique(dev, kind, launches):
    """Phase 4c: PRO over a non-unique build side, against the ht tier."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.types import Relation

    params = G.WorkloadParams(r_size=NU_R_SIZE, s_size=B_SIZE,
                              nonunique_keys=True)
    rk, rp, sk, sp = G.build_workload(params)
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    S = Relation.from_numpy(sk, sp, device=dev)
    del rk, rp, sk, sp
    ref_count, ref_sums = plain_reference("PRO", R, S, "non-unique")
    res, st, sums, ran = drive(
        "PRO", R, S, EngineConfig(allow_dense=False),
        ("partition_kv", "table_build", "table_probe"),
        "PRO non-unique 16M x 128M", kind)
    if st.tier != "cuda_prho":
        raise AssertionError(f"non-unique PRO: tier {st.tier} != cuda_prho")
    if res.count() != ref_count or tuple(sums) != tuple(ref_sums):
        raise AssertionError(f"non-unique PRO: {res.count()} {sums} != "
                             f"ht {ref_count} {ref_sums}")
    add_launches(launches, ran)


def run_key8b(dev, kind, launches):
    """Phase 4k: workload A, PRO 2^24 ⋈ 2^28 over 16-byte tuples at q = 1:
    cuda_key8b (the partition, the bitmap build and probe over the low
    words), then the plain wide tier on the same relations (no R stats),
    its 64-bit sums against ref_join's on the low words, its peak device
    memory and its stable sort and segment starts alone, then materialize8b at 2^20 ⋈ 2^24 against the host's pairs."""
    import dataclasses
    import torch
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.models import registry
    from hwbloomradixjoin_tpu_torch.ops import xla_join
    from hwbloomradixjoin_tpu_torch.types import Relation
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    t0 = time.perf_counter()
    params = G.WorkloadParams(r_size=A_R_SIZE, s_size=A_S_SIZE, nthreads=8,
                              key8b=True)
    rk, rp, sk, sp = G.build_workload(params)
    gen_s = time.perf_counter() - t0
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params),
                            key8b=True)
    S = Relation.from_numpy(sk, sp, device=dev, key8b=True)
    check_ms = time_usec(lambda: registry.high_words_zero(R, S), dev) / 1e3
    print(f"workload A: host generation {gen_s:.1f}s; the plan-time "
          f"high-word check {check_ms:.4f} ms", flush=True)
    cfg = EngineConfig(allow_dense=False)
    res, st, sums, ran = drive(
        "PRO", R, S, cfg, ("partition", "bitmap_build", "bitmap_probe"),
        "workload A (KEY_8B) PRO 2^24 x 2^28", kind)
    if st.tier != "cuda_key8b" or res.count() != A_S_SIZE or sums != (0, 0):
        raise AssertionError(f"workload A: tier {st.tier} count "
                             f"{res.count()} sums {sums}")
    add_launches(launches, ran)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    wres, wst, wsums, _ = drive("PRO", dataclasses.replace(R, stats=None), S,
                                cfg, (), "workload A, the plain key8b tier",
                                kind)
    peak = torch.cuda.max_memory_allocated(dev)
    rs_bytes = nbytes(R.key, R.key_hi, R.payload, R.payload_hi, S.key,
                      S.key_hi, S.payload, S.payload_hi)
    _, want_r, want_s = native.ref_join(rk, rp, sk, sp)
    want = (want_r % 2**64, want_s % 2**64)
    if wst.tier != "key8b" or wres.count() != A_S_SIZE or wsums != want:
        raise AssertionError(f"key8b tier: {wst.tier} {wres.count()} "
                             f"{wsums} != {want}")
    print(f"key8b tier: sums {wsums} = ref_join's; peak device memory "
          f"{peak / 2**30:.3f} GiB, {(peak - base) / 2**30:.3f} GiB over the "
          f"{base / 2**30:.3f} GiB allocated before it (R and S, "
          f"{rs_bytes / 2**30:.3f} GiB, and the plans phase 5 times)",
          flush=True)
    keys = xla_join.wide(torch.cat([R.key_hi, S.key_hi]),
                         torch.cat([R.key, S.key]))
    sort_ms = time_usec(lambda: torch.sort(keys, stable=True), dev) / 1e3
    srt = torch.sort(keys, stable=True).values
    seg_ms = time_usec(lambda: xla_join.segment_starts(srt), dev) / 1e3
    print(f"key8b tier's steps alone: the stable sort of {keys.numel()} "
          f"int64 keys {sort_ms:.4f} ms, segment_starts {seg_ms:.4f} ms",
          flush=True)
    del R, S, rk, rp, sk, sp, keys, srt
    torch.cuda.empty_cache()

    params = G.WorkloadParams(r_size=A_MAT_R_SIZE, s_size=A_MAT_S_SIZE,
                              nthreads=8, key8b=True)
    rk, rp, sk, sp = G.build_workload(params)
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params),
                            key8b=True)
    S = Relation.from_numpy(sk, sp, device=dev, key8b=True)
    mres, mst, _, _ = drive("PRO", R, S, EngineConfig(materialize=True), (),
                            "materialize8b 2^20 x 2^24", kind)
    pay_of = np.zeros(A_MAT_R_SIZE + 1, np.int64)
    pay_of[rk] = rp
    want = np.stack([pay_of[sk], sp.astype(np.int64)])
    got = np.stack([mres.r_payload.cpu().numpy(),
                    mres.s_payload.cpu().numpy()])
    if mst.tier != "materialize8b" or mres.count() != A_MAT_S_SIZE \
            or not np.array_equal(got[:, np.lexsort(got[::-1])],
                                  want[:, np.lexsort(want[::-1])]):
        raise AssertionError(f"materialize8b: {mst.tier} {mres.count()} "
                             "pairs differ from the host's")
    print(f"materialize8b: {mres.count()} int64 pairs = the host's",
          flush=True)


def probe_largest_cta(plan, sms):
    """(class, CTAs, the largest CTA's share of the keys) of the bitmap
    probe over a one-pass plan's S partition: each CTA's keys from the
    partition's starts and run_split's mapping of a CTA to its work (its
    range's runs in each segment of its span, and its share of their pad
    runs)."""
    import torch
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B

    s_part, starts = plan._intermediates()["s_part"]
    split = B.probe_split(s_part, starts, plan.sgeom.shift,
                          plan.sgeom.part_bits, None, sms)
    if split is None:
        return "flat", None, None
    e, fs, nr = split.seg_elems, split.seg_buckets, split.nranges
    st = starts.reshape(split.nseg, split.cat_words)[:, :fs + 1].long()
    st = st.clamp(max=e)
    j0 = torch.arange(nr, device=st.device) * split.nb
    j1 = (j0 + split.nb).clamp(max=fs)
    rng = torch.arange(nr + 1, device=st.device)
    p0 = st[:, fs:]
    pads = p0 + (e - p0) * rng // nr
    work = st[:, j1] - st[:, j0] + pads[:, 1:] - pads[:, :-1]
    spans = torch.zeros(split.nspans * split.span, nr, dtype=torch.int64,
                        device=st.device)
    spans[:split.nseg] = work
    per_cta = spans.view(split.nspans, split.span, nr).sum(1)
    return "staged", split.ctas, int(per_cta.max()) / int(per_cta.sum())


def run_zipf(dev, kind, launches, sms, pro_plan):
    """Phase 4l: PRO 16M ⋈ 128M with a Zipf S (z = 1.0 over R's keys,
    every S key in R) on cuda_radix; the host generation time, the count
    (S's size), the hottest key's share of S and the bitmap probe's largest
    CTA share beside the uniform q = 1 S's."""
    import torch
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join
    from hwbloomradixjoin_tpu_torch.types import Relation

    t0 = time.perf_counter()
    params = G.WorkloadParams(r_size=R_SIZE, s_size=S_SIZE, nthreads=8,
                              skew=ZIPF_Z)
    rk, rp, sk, sp = G.build_workload(params)
    gen_s = time.perf_counter() - t0
    hot = int(np.bincount(sk).max()) / len(sk)
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    S = Relation.from_numpy(sk, sp, device=dev)
    res, st, _, ran = drive("PRO", R, S, EngineConfig(allow_dense=False),
                            ("partition", "bitmap_build", "bitmap_probe"),
                            f"PRO 16M x 128M Zipf z={ZIPF_Z}", kind)
    if st.tier != "cuda_radix" or res.count() != S_SIZE:
        raise AssertionError(f"Zipf: tier {st.tier} count {res.count()}")
    add_launches(launches, ran)
    plan = bitmap_join.plan_radix_join(R.key, S.key, 1, R_SIZE, device=dev)

    def split(p):
        cls, ctas, share = probe_largest_cta(p, sms)
        return cls if ctas is None else (
            f"{cls}, {ctas} CTAs, the largest CTA {share * 100:.4f} % of "
            "the keys walked")
    print(f"Zipf z={ZIPF_Z}: host generation {gen_s:.1f}s, hottest key "
          f"{hot * 100:.3f} % of S; bitmap probe {split(plan)} (uniform "
          f"q = 1: {split(pro_plan)})", flush=True)
    del plan
    run_aggregates(dev, sk, R, S)
    del R, S
    torch.cuda.empty_cache()


def run_distributed(dev, kind, launches, pro):
    """Phase 4m: the distributed join (parallel/dist_join.py) on a world of
    one over NCCL at PRO's 16M ⋈ 128M: the sort-scan and the bitmap
    (pallas) local engines at q = 1 and q = 0.01, count and checksums
    against the ht tier's on the card (the pallas engine count only, with
    kernels 1, 3 and 4 launched), then 4e's blocked filter (m = 2^27, k =
    1, B = 512) at q = 0.01 on both engines, its S-tuples after filter equal
    to run_join's in the same call; each time beside run_join("PRO")'s."""
    import torch
    import torch.distributed as dist
    from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                                   EngineConfig)
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.parallel import dist_join, mesh
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    group = mesh.make_mesh(1, dev)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"world of one on {dist.get_backend()}")
    args = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 27, k=1, B=512)
    cfg = EngineConfig(allow_dense=False)
    try:
        for q in (1.0, 0.01):
            _, R, S = pro[q]
            expect = G.expected_uniform_match_count(S_SIZE, q)
            _, sums = plain_reference("PRO", R, S, f"dist q={q}")
            _, st, _, _ = drive("PRO", R, S, cfg, (), f"run_join PRO q={q}",
                                kind)
            runs = [(e, None) for e in dist_join.ENGINES]
            if q != 1.0:
                _, bst, _, _ = drive("PRO", R, S, cfg, (),
                                     f"run_join BPRO q={q}", kind,
                                     bloom_args=args)
                runs += [(e, args) for e in dist_join.ENGINES]
            for engine, bloom_args in runs:
                plan = dist_join.plan_dist_join(
                    group, R.key, R.payload, S.key, S.payload, bloom_args,
                    local_engine=engine, device=dev)
                label = f"dist[1] {engine}{' + filter' if bloom_args else ''}"
                _build.reset_launches()
                out = [int(v) for v in plan.run()]
                ran = dict(_build.LAUNCHES)
                want = [expect, *(sums if engine == "sortscan" else (0, 0)),
                        -1 if bloom_args is None else bst.s_after_filter, 0]
                if out != want:
                    raise AssertionError(f"{label} q={q}: {out} != {want}")
                if engine == "pallas":
                    missing = [k for k in ("partition", "bitmap_build",
                                           "bitmap_probe") if not ran[k]]
                    if missing:
                        raise AssertionError(f"{label}: kernels never "
                                             f"launched: {missing}")
                    add_launches(launches, ran)
                ms = time_usec(plan.run, dev) / 1e3
                ref = bst if bloom_args is not None else st
                print(f"{label} q={q} on {kind}: count={out[0]} sums="
                      f"{out[1:3]} s_after_filter={out[3]} overflow={out[4]}"
                      f" total={ms:.4f}ms (run_join {'BPRO' if bloom_args else 'PRO'} "
                      f"{ref.total_usec / 1e3:.4f}ms) launches={ran}",
                      flush=True)
                del plan
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def run_operators(dev, R, S, kind, launches):
    """Phase 4n: the standalone operators over PRO q = 1's S (128M keys):
    radix_cluster at 6 bits of [1, 16M] (kernel 1; each chunk a stable
    bucket-major permutation: the twin's output on the card) and
    radix_sort of (key, row) rows, ordered and stable; each timed."""
    import torch
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.ops import radix as X
    from hwbloomradixjoin_tpu_torch.ops import sort
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    keys = S.key[:S_SIZE]
    _build.reset_launches()
    out, starts = sort.radix_cluster(keys, 1, R_SIZE, 6, device=dev)
    ran = dict(_build.LAUNCHES)
    if not ran["partition"]:
        raise AssertionError("radix_cluster: kernel 1 never launched")
    add_launches(launches, ran)
    geom = X.RadixGeom(chunk_rows=1024, part_bits=6, lo=1, hi=R_SIZE,
                       shift=(R_SIZE - 1).bit_length() - 6)
    t_out, t_starts = X.partition_pass_plain(
        X._chunk_pad(keys, 1024 * 128, dev), geom)
    if not (torch.equal(out, t_out)
            and torch.equal(starts.view(-1, 128), t_starts)):
        raise AssertionError("radix_cluster differs from its twin")
    del t_out, t_starts
    ms = time_usec(lambda: sort.radix_cluster(keys, 1, R_SIZE, 6,
                                              device=dev), dev) / 1e3
    print(f"radix_cluster 128M keys, 6 bits, {starts.shape[0]} chunks: "
          f"the twin's permutation and starts; {ms:.4f} ms; launches={ran}",
          flush=True)
    del out, starts
    rows = torch.arange(keys.numel(), dtype=torch.int32, device=dev)
    ks, ps = sort.radix_sort(keys, rows)
    up = ks[1:] > ks[:-1]
    tie = (ks[1:] == ks[:-1]) & (ps[1:] > ps[:-1])
    if not bool((up | tie).all()) or not torch.equal(keys[ps.long()], ks) \
            or not bool((torch.bincount(ps.long(), minlength=keys.numel())
                         == 1).all()):
        raise AssertionError("radix_sort: not a stable ordering")
    del ks, ps, up, tie
    ms = time_usec(lambda: sort.radix_sort(keys, rows), dev) / 1e3
    print(f"radix_sort 128M (key, row) rows: ordered and stable; {ms:.4f} "
          "ms", flush=True)
    del rows
    torch.cuda.empty_cache()


def run_aggregates(dev, sk, R, S):
    """Phase 4n, over 4l's Zipf S (z = 1.0, 128M keys over R's 16M):
    group_by_key with S's payloads as values (the counts total |S|, the
    sums total the values mod 2^32, the groups as many as the host's
    distinct keys, and a 2^20-row slice equal to the CPU function's
    output), and join_group_count of R with S (the group counts total the
    join's count, |S|); each timed."""
    import torch
    from hwbloomradixjoin_tpu_torch.ops import aggregate
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    uk, uc, us, ng = aggregate.group_by_key(S.key, S.payload)
    want_ng = int(np.count_nonzero(np.bincount(sk)))
    vsum = int((S.payload.long() & 0xFFFFFFFF).sum()) % 2**32
    if int(ng) != want_ng or int(uc.long().sum()) != S_SIZE \
            or int(us.sum()) % 2**32 != vsum:
        raise AssertionError(f"group_by_key: {int(ng)} groups (host "
                             f"{want_ng}), counts {int(uc.long().sum())}")
    n = 1 << 20
    got = aggregate.group_by_key(S.key[:n], S.payload[:n])
    want = aggregate.group_by_key(S.key[:n].cpu(), S.payload[:n].cpu())
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("group_by_key: the 2^20-row slice differs "
                             "from the CPU's")
    del uk, uc, us, got
    ms = time_usec(lambda: aggregate.group_by_key(S.key, S.payload),
                   dev) / 1e3
    print(f"group_by_key Zipf z={ZIPF_Z} 128M rows: {want_ng} groups = the "
          f"host's, counts total |S|, sums the values' mod 2^32, 2^20 rows "
          f"= the CPU's; {ms:.4f} ms", flush=True)
    keys, cnts, ng = aggregate.join_group_count(R.key, S.key)
    if int(cnts.long().sum()) != S_SIZE:
        raise AssertionError(f"join_group_count totals "
                             f"{int(cnts.long().sum())} != {S_SIZE}")
    del keys, cnts
    ms = time_usec(lambda: aggregate.join_group_count(R.key, S.key),
                   dev) / 1e3
    print(f"join_group_count R x Zipf S: {int(ng)} groups totalling the "
          f"join's {S_SIZE}; {ms:.4f} ms", flush=True)
    torch.cuda.empty_cache()


def run_ranks_on_one_card() -> None:
    """Phase 4o: the multiproc dry run as 4 gloo processes sharing the
    card (NCCL takes one process a card), 2^22 ⋈ 2^25: the blocked filter,
    a heavy key and a Zipf S (z = 1.0) with skew handling, the Zipf S
    without it, and the bitmap engine; every count and checksum equal to
    ref_join's, the survivors to the host filter's.  Its host times are
    gloo's staging through the host, no multi-GPU number."""
    from hwbloomradixjoin_tpu_torch.parallel import multiproc

    t0 = time.perf_counter()
    multiproc.dryrun(4, "cuda", "gloo", r_size=1 << 22, s_size=1 << 25,
                     m=1 << 25)
    print(f"4 gloo ranks on one card: {time.perf_counter() - t0:.1f}s wall",
          flush=True)


def cli(args, expect, label, module="cli", tier=None):
    """One run of the port's command line (python -m ...) in a subprocess:
    its stdout, parsed by the port's measurements.run.parse_result when it
    prints the relation lines, with Results = expect.  With tier, the run
    adds --engine-sync-stats and must name that tier and report partition
    time."""
    import sys
    from pathlib import Path
    from hwbloomradixjoin_tpu_torch.measurements.run import parse_result
    root = Path(__file__).resolve().parent

    if tier is not None:
        args = [*args, "--engine-sync-stats"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", f"hwbloomradixjoin_tpu_torch.{module}",
         *map(str, args)], capture_output=True, text=True, cwd=root,
        timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    out = proc.stdout
    if expect is not None and f"Results = {expect}. DONE." not in out:
        raise AssertionError(f"{label}: no 'Results = {expect}'\n{out}")
    d = parse_result(out) if "relation S with size" in out else None
    if d is not None:
        if d["results"] != expect or d["out-tuples"] != expect:
            raise AssertionError(f"{label}: parse_result {d}")
        # the distributed join reports no phases, only its tier; it warns
        # of nothing (a capacity drop would make its count invalid)
        if tier is not None and tier.startswith("dist[") and "[WARN ]" in out:
            raise AssertionError(f"{label}: a warning\n{out}")
        if tier is not None and (f"[SYNC] tier={tier} " not in out
                                 or (d["partition-usecs"] <= 0
                                     and not tier.startswith("dist["))):
            raise AssertionError(f"{label}: not tier {tier} with a "
                                 f"partition\n{out}")
        print(f"{label}: Results = {expect}, total "
              f"{d['time-usecs'] / 1e3:.4f} ms, ns/S-tuple "
              f"{d['nsec-per-tuple']}, part {d['partition-usecs'] / 1e3:.4f}"
              f" ms, probe {d['probe-usecs'] / 1e3:.4f} ms; {wall:.1f}s "
              "wall", flush=True)
    else:
        print(f"{label}: {wall:.1f}s wall", flush=True)
    return out


def run_entry_points() -> None:
    """Phase 6: the port's CLI, confrun and unittests as a user runs them,
    each in its own process on the card."""
    import tempfile
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.data import tblio
    from hwbloomradixjoin_tpu_torch.unittests import _edh_final
    from hwbloomradixjoin_tpu_torch.data import native

    cli(["-a", "PRO", "-r", 16_000_000, "-s", 128_000_000, "-q", 0.01, "-b",
         "blocked", "-m", 134217728, "-k", 1, "-B", 512, "--engine-no-dense"],
        G.expected_uniform_match_count(128_000_000, 0.01), "cli 4e (BPRO)",
        tier="cuda_radix")
    cli(["-a", "PRO", "-r", A_R_SIZE, "-s", A_S_SIZE, "--key8b", "-n", 8],
        A_S_SIZE, "cli --key8b workload A", tier="cuda_key8b")
    cli(["-a", "PRO", "-r", R_SIZE, "-s", S_SIZE, "-z", ZIPF_Z,
         "--engine-no-dense"], S_SIZE, f"cli -z {ZIPF_Z}", tier="cuda_radix")
    cli(["-a", "PRHO", "-r", 1 << 24, "-s", 1 << 24, "--engine-no-dense"],
        1 << 24, "cli PRHO 2^24 x 2^24", tier="cuda_prho")
    for engine in ("sortscan", "pallas"):
        cli(["-a", "PRO", "-r", R_SIZE, "-s", S_SIZE, "-n", 8,
             "--engine-devices", 1, "--engine-local-join", engine], S_SIZE,
            f"cli --engine-devices 1 --engine-local-join {engine}",
            tier=f"dist[1]/{engine}")
    with tempfile.TemporaryDirectory() as tmp:
        out_tbl = os.path.join(tmp, "Out.tbl")
        n = G.expected_uniform_match_count(800_000, 0.5)
        cli(["-a", "PRO", "-r", 100_000, "-s", 800_000, "-q", 0.5,
             "--materialize", "--out-file", out_tbl], n,
            "cli --materialize --out-file")
        r_pay, s_pay = tblio.read_relation(out_tbl)
        rk, rp, sk, sp = G.build_workload(G.WorkloadParams(
            r_size=100_000, s_size=800_000, selectivity=0.5))
        pay_of = np.full(100_001, -1, np.int64)
        pay_of[rk] = rp
        hit = (sk >= 1) & (sk <= 100_000)
        want = sorted(zip(pay_of[sk[hit]].tolist(), sp[hit].tolist()))
        if len(r_pay) != n or sorted(zip(r_pay.tolist(),
                                         s_pay.tolist())) != want:
            raise AssertionError("Out.tbl differs from the host's pairs")
        out = cli(["-a", "PRO", "-r", 1_000_000, "-s", 8_000_000,
                   "--engine-no-dense", "--verbose"], 8_000_000,
                  "cli --verbose", tier="cuda_radix")
        if "roofline (H100" not in out or "attained" not in out:
            raise AssertionError(f"--verbose: no H100 bound\n{out}")
        print([ln for ln in out.splitlines() if "roofline" in ln
               or " ms " in ln], flush=True)
        trace_dir = os.path.join(tmp, "trace")
        cli(["-a", "PRO", "-r", 1_000_000, "-s", 8_000_000,
             "--engine-no-dense", "--engine-trace", trace_dir], 8_000_000,
            "cli --engine-trace", tier="cuda_radix")
        traces = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
        if not traces:
            raise AssertionError("--engine-trace wrote no trace")
        print(f"trace: {traces[0]} "
              f"{os.path.getsize(os.path.join(trace_dir, traces[0]))} "
              "bytes", flush=True)
        conf = os.path.join(tmp, "pro.conf")
        with open(conf, "w") as f:
            json.dump({"algorithm": "PRO", "threads": 8,
                       "build": {"size": 1_000_000},
                       "probe": {"size": 8_000_000, "selectivity": 1.0},
                       "engine": {"use_pallas": True}}, f)
        out = cli([conf], 8_000_000, "confrun PRO 1M x 8M",
                  module="confrun")
        if "RUNTIME TOTAL, BUILD+PART, PART (cycles):" not in out:
            raise AssertionError(f"confrun: no summary line\n{out}")
    out = cli([0, 19201, 1_000_000], None, "unittests 0",
              module="unittests")
    rows = out.strip().splitlines()
    if len(rows) != 11 or rows[0] != ("algorithm;time_total_ms;"
                                      "time_single_ns;collisions;"
                                      "collisions_pct"):
        raise AssertionError(f"unittests 0:\n{out}")
    print(rows[1], rows[-1], flush=True)
    out = cli([1, 19201, 1_000_000], None, "unittests 1", module="unittests")
    h0, y0 = (int(v) & 0xFFFFFFFF for v in native.rand_stream(19201, 2))
    h, y = _edh_final(h0, y0, 1_000_000)
    want = f"h: {np.int32(np.uint32(h))}, y: {np.int32(np.uint32(y))}"
    if not out.startswith(want) or "cycles_per_hash" not in out:
        raise AssertionError(f"unittests 1:\n{out}")
    print(out.strip().replace("\n", " | "), flush=True)


def run_quick_sweep() -> list:
    """Phase 6b: the port's sweep driver (measurements.run) runs its quick
    sweep through the CLI on the card, one subprocess a configuration:
    every row parsed by the port's parse_result, with a tier and an exact
    Results line."""
    import tempfile
    from hwbloomradixjoin_tpu_torch.measurements import run

    with tempfile.TemporaryDirectory() as tmp:
        rows = run.sweep_quick(out_dir=tmp)
        saved = run.load_rows("quick", tmp)
    for r in rows:
        if not (r["exact"] and r["results"] == r["out-tuples"]
                and r["tier"] and r["backend"] == "auto"):
            raise AssertionError(f"quick sweep row: {r}")
        print(f"sweep quick: {r['algorithm']} bloom={r['bloom_filter']} "
              f"tier={r['tier']} Results={r['results']} (expected "
              f"{r['expected']}) filtered={r['filtered']} "
              f"{r['time-usecs'] / 1e3:.4f} ms; {r['wall-secs']:.1f}s wall",
              flush=True)
    if len(rows) != 3 or saved != rows:
        raise AssertionError(f"quick sweep: {len(rows)} rows, saved "
                             f"{len(saved)}")
    return rows


def run_tools(quick_rows) -> None:
    """Phase 7: the port's tools on the card, each through its main() as
    python -m runs it, each required to exit 0; then the analysis of phase
    6b's rows, which must name this card, class each row against its L2
    and give a bloom-superiority fraction that is a number."""
    import math
    import tempfile
    from pathlib import Path
    import torch
    from hwbloomradixjoin_tpu_torch.measurements import analysis, run
    from hwbloomradixjoin_tpu_torch.tools import (build_check, microbench,
                                                  part_bench, validate_key8b,
                                                  validate_pro)
    from hwbloomradixjoin_tpu_torch.utils.roofline import card_line

    for label, main, args in (
            ("validate_pro", validate_pro.main, []),
            ("build_check", build_check.main, []),
            ("part_bench", part_bench.main, [str(R_SIZE), "--widths"]),
            ("microbench", microbench.main, []),
            ("validate_key8b", validate_key8b.main,
             ["--r", str(A_MAT_R_SIZE), "--s", str(A_MAT_S_SIZE)])):
        t0 = time.perf_counter()
        rc = main(args)
        torch.cuda.empty_cache()
        if rc != 0:
            raise AssertionError(f"{label} {' '.join(args)}: exit {rc}")
        print(f"{label} {' '.join(args)}: exit 0, "
              f"{time.perf_counter() - t0:.1f}s wall", flush=True)
    card = card_line()
    with tempfile.TemporaryDirectory() as tmp:
        run.save_data(quick_rows, "quick", tmp)
        got = analysis.analyze(Path(tmp) / "quick.jsonl")
        cross = analysis.cross_run_table(tmp)
    sup = got["superiority"]
    if sup is None or math.isnan(sup) or any(
            r["device"] != card or r.get("footprint") not in ("S", "M", "L")
            for r in got["rows"]) or cross[0]["device"] != card:
        raise AssertionError(f"analysis of the quick sweep: fraction {sup}, "
                             f"rows {got['rows']}")
    print(f"analysis of the quick sweep on {card}: bloom-superiority "
          f"fraction {sup:.3f}, footprints "
          f"{[r['footprint'] for r in got['rows']]}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def time_kernels(dev, pro_plans, b_plan, two_pass, bpro, dense_in, mat_plan,
                 gp_parts, err) -> dict:
    """Phase 5: name -> (kernel ms, twin ms, bound ms, bound_by) at the main
    paths' full shapes: PRO's partition and probe of S at q=1, compaction
    of S at q=0.01, build of R; workload B's partition of S with payloads,
    table build from R and probe of S with payloads; 4d's pass 2 (range
    mode), pass 2 in hash mode at the flagship's 10 + 3 bits over 4e's S,
    and 4e's hash partition and bloom probe of S; 4g's dense count of S at
    q=1, 4h's materialization of S at q=1 and 4i's gathered probe.  Each
    kernel's output there must equal its twin's bit for bit (folded into
    err)."""
    import torch
    from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import bloom_pallas as BP
    from hwbloomradixjoin_tpu_torch.ops import dense_join as D
    from hwbloomradixjoin_tpu_torch.ops import multipass as M
    from hwbloomradixjoin_tpu_torch.ops import prho_join as P
    from hwbloomradixjoin_tpu_torch.ops import radix as X
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    p1, p2 = pro_plans[1.0], pro_plans[0.01]
    m = p1._intermediates()
    g, rg = p1.sgeom, p1.rgeom
    build_args = (m["r_part"], 1, R_SIZE, rg.part_bits, rg.shift, p1.r_sl_rows)
    r_starts = m["r_starts"]
    s_part, s_starts = m["s_part"]
    probe_args = (m["bitmap"], s_part, 1, g.shift, g.part_bits, p1.sl_rows)
    compact_args = (p2.sk_in, 1, R_SIZE, g.chunk_rows, p2.cap_rows)
    mb = b_plan._intermediates()
    gb, slr = b_plan.geom, b_plan.slice_rows
    r_kv, tables, s_kv = mb["r_part"], mb["tables"], mb["s_part"]
    tb_args = (r_kv[0], r_kv[1], 1, B_SIZE, gb.part_bits, gb.shift, slr)
    pr_args = (*tables, *s_kv[:2], 1, gb.shift, gb.part_bits, slr)
    keys = s_kv[0].reshape(-1)
    live = keys[(keys >= 1) & (keys < 1 + ((1 << gb.part_bits) << gb.shift))]
    slots_needed = torch.unique(live).numel()
    del keys, live
    s1 = two_pass.s_partition()
    prune = bpro.prune
    words, (hashed, h_starts) = prune.build(), prune.partition()
    # hash-mode pass 2 at the flagship's geometry (10 + 3 of 21 block bits)
    # over 4e's S, planned as the prune plans it
    flag = BloomArgs(variant=BloomVariant.BLOCKED, m=1 << 30, k=1, B=512)
    part_bits, hash_bits = BP.geometry_raw(flag)
    h1 = X.partition_pass(prune.sk_in, X.RadixGeom(
        chunk_rows=prune.pgeom.chunk_rows, part_bits=BP.MAX_PART_BITS,
        hash_seed=flag.seed, hash_bits=hash_bits))
    h2 = M.plan_pass2(*h1, BP.MAX_PART_BITS, part_bits - BP.MAX_PART_BITS,
                      prune.pgeom.chunk_rows, None, hash_seed=flag.seed,
                      hash_bits=hash_bits)
    mb = mat_plan._intermediates()
    mg, mslr = mat_plan.geom, mat_plan.slice_rows
    m_kv = mb["s_part"]
    mat_args = (*mb["tables"], *m_kv[:2], 1, mg.shift, mg.part_bits, mslr)
    keys = m_kv[0].reshape(-1)
    mat_slots = torch.unique(keys[(keys >= 1) & (keys <= R_SIZE)]).numel()
    del keys
    ggeom = X.RadixGeom()
    f_words = ((1 << ggeom.part_bits) + 1) * 4
    gp_starts = f_words * (gp_parts[1].numel() + gp_parts[3].numel()) \
        // (ggeom.cat_rows * 128)
    # name -> (kernel, twin, bytes read, input elements)
    pairs = {
        "partition": (lambda: X.partition_pass(p1.sk_in, g),
                      lambda: X.partition_pass_plain(p1.sk_in, g),
                      nbytes(p1.sk_in), p1.sk_in.numel()),
        "compact": (lambda: X.compact_pass(*compact_args),
                    lambda: X.compact_pass_plain(*compact_args),
                    nbytes(p2.sk_in), p2.sk_in.numel()),
        "bitmap_build": (lambda: B.bitmap_build(*build_args, r_starts),
                         lambda: B.build_bitmap(*build_args),
                         nbytes(m["r_part"], r_starts), m["r_part"].numel()),
        # at q=1 S covers R's whole key range, so it needs every bitmap word
        "bitmap_probe": (lambda: B.bitmap_probe_count(*probe_args, s_starts),
                         lambda: B.bitmap_probe_count_plain(*probe_args),
                         nbytes(s_part, s_starts, m["bitmap"]),
                         s_part.numel()),
        "partition_kv": (
            lambda: X.partition_pass_kv(b_plan.sk_in, b_plan.sp_in, gb),
            lambda: X.partition_pass_kv_plain(b_plan.sk_in, b_plan.sp_in, gb),
            nbytes(b_plan.sk_in, b_plan.sp_in), b_plan.sk_in.numel()),
        "table_build": (lambda: P.table_build(*tb_args, r_kv[2]),
                        lambda: P.build_tables(*tb_args),
                        nbytes(*r_kv), r_kv[0].numel()),
        # the probe needs S's two columns and the two 4-byte slots of each
        # distinct in-range S key
        "table_probe": (lambda: P.probe_count_sums(*pr_args, s_kv[2]),
                        lambda: P.probe_count_sums_plain(*pr_args),
                        nbytes(*s_kv[:2]) + 8 * slots_needed,
                        s_kv[0].numel()),
        "partition_hash": (
            lambda: X.partition_pass(prune.sk_in, prune.pgeom),
            lambda: X.partition_pass_plain(prune.sk_in, prune.pgeom),
            nbytes(prune.sk_in), prune.sk_in.numel()),
        # range mode reads each bucket's window of each chunk: count the
        # pass-1 keys once, as the bound's rule has it
        "pass2_partition": (
            lambda: M.pass2_partition(*s1, two_pass.pass2),
            lambda: M.pass2_partition_plain(*s1, two_pass.pass2),
            nbytes(*s1), s1[0].numel()),
        "pass2_partition_hash": (
            lambda: M.pass2_partition(*h1, h2),
            lambda: M.pass2_partition_plain(*h1, h2),
            nbytes(*h1), h1[0].numel()),
        "bloom_probe": (
            lambda: BP.bloom_probe_prune(words, hashed, prune.args,
                                         starts=h_starts,
                                         part_bits=prune.pgeom.part_bits),
            lambda: BP.bloom_probe_prune_plain(words, hashed, prune.args),
            nbytes(hashed, h_starts, words), hashed.numel()),
        "dense_count": (lambda: D.dense_count_join(*dense_in, 1, R_SIZE),
                        lambda: D.dense_count_join_plain(*dense_in, 1,
                                                         R_SIZE),
                        nbytes(*dense_in), dense_in[0].numel()),
        # S's two columns, and the two 4-byte slots of each distinct
        # in-range S key
        "materialize": (lambda: P.materialize_pairs(*mat_args, m_kv[2]),
                        lambda: P.materialize_pairs_plain(*mat_args),
                        nbytes(*m_kv[:2]) + 8 * mat_slots,
                        m_kv[0].numel()),
        # both partitions once, and the F + 1 starts words of each chunk
        "gathered_probe": (
            lambda: X.gathered_probe_count(*gp_parts, ggeom),
            lambda: X.gathered_probe_count_plain(*gp_parts, ggeom),
            nbytes(gp_parts[0], gp_parts[2]) + gp_starts,
            gp_parts[0].numel() + gp_parts[2].numel()),
    }
    times = {}
    for name, (kern, plain, read, elems) in pairs.items():
        ms = time_usec(kern, dev) / 1e3
        plain_ms = time_usec(plain, dev) / 1e3
        got, want = kern(), plain()
        record(err, name, got, want)
        written = nbytes(*(got if isinstance(got, tuple) else (got,)))
        t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
        t_ops = elems * OPS_PER_ELEM[name] / INT32_OPS_PER_S * 1e3
        times[name] = (ms, plain_ms, max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")
        print(f"{name}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
              f"{times[name][2]:.4f} ms ({read + written} bytes)", flush=True)
    keys_only = (*tables, s_kv[0], None, 1, gb.shift, gb.part_bits, slr)
    record(err, "table_probe", P.probe_count_sums(*keys_only, s_kv[2]),
           P.probe_count_sums_plain(*keys_only))
    print("kernel vs twin: bit-exact at the main paths' full shapes",
          flush=True)
    return times


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.ops import run_split

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    kind = torch.cuda.get_device_name(0)

    t0 = time.perf_counter()
    _build.lib()
    info = _build.build_info
    print(f"build: {time.perf_counter() - t0:.2f}s (nvcc {info['seconds']:.2f}s)"
          f" -> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if "Used" in line or "spill" in line:
            print("ptxas:", line.strip(), flush=True)

    def done(phase, t0):
        print(f"phase {phase}: {time.perf_counter() - t0:.1f}s wall",
              flush=True)
        return time.perf_counter()

    t0 = time.perf_counter()
    err = {}
    rng = np.random.default_rng(2026)
    compare_kernels(dev, rng, err)
    compare_table_kernels(dev, rng, err)
    t0 = done("3 (kernel vs twin)", t0)

    compare_build_geometries(dev, rng, err)
    compare_bloom_kernels(dev, rng, err)
    t0 = done("3d (build geometries, bloom kernels vs twins)", t0)
    compare_fullrange_kernels(dev, rng, err)
    t0 = done("3f (partition, build and probe at the full span)", t0)
    compare_new_kernels(dev, rng, err)
    t0 = done("3e (dense, materialize, gathered probe vs twins)", t0)

    launches = {k: 0 for k in KERNELS}
    pro = {q: run_pro_path(dev, q, kind, launches) for q in (1.0, 0.01)}
    pro_plans = {q: plan for q, (plan, _, _) in pro.items()}
    t0 = done("4 (PRO 16M x 128M)", t0)
    run_distributed(dev, kind, launches, pro)
    t0 = done("4m (distributed join, a world of one over NCCL)", t0)
    run_operators(dev, *pro[1.0][1:], kind, launches)
    t0 = done("4n (radix_cluster, radix_sort)", t0)
    b_plan, b_r, b_s, b_sums, probe_ms = run_workload_b(dev, kind, launches)
    t0 = done("4b (workload B)", t0)
    probe_ms = {13: probe_ms, **run_wide_bits(b_r, b_s, b_sums, kind,
                                              launches)}
    partition_widths(dev, b_plan.sk_in, b_plan.sp_in)
    del b_r, b_s
    torch.cuda.empty_cache()
    t0 = done("4j (PRHO at 14-17 bits, partition widths)", t0)
    run_nonunique(dev, kind, launches)
    t0 = done("4c (non-unique build)", t0)
    two_pass = run_two_pass(*pro[1.0][1:], kind, launches, err)
    t0 = done("4d (two-pass PRO)", t0)
    bpro = run_bpro(*pro[0.01][1:], kind, launches, err)
    t0 = done("4e (BPRO 16M x 128M)", t0)
    run_validations(dev, *pro[0.01][1:], kind, launches)
    t0 = done("4p (validate_fullrange, validate_bloom at k = 2, 4)", t0)
    for q in (1.0, 0.01):
        run_dense(*pro[q][1:], q, kind, launches)
    t0 = done("4g (dense PRO, EngineConfig())", t0)
    mat = {q: run_materialize(*pro[q][1:], q, kind, launches)
           for q in (1.0, 0.01)}
    mat_plan = mat[1.0][0]
    torch.cuda.empty_cache()
    print("table_probe by width (workload B, PRHO's probe phase): "
          + ", ".join(f"{b} bits {ms:.4f} ms" for b, ms in probe_ms.items())
          + "; materialize (4h's phase): "
          + ", ".join(f"q={q} {m[1]:.4f} ms" for q, m in mat.items()),
          flush=True)
    t0 = done("4h (materialize)", t0)
    gp_parts = run_radix_count(*pro[1.0][1:], kind, launches)
    t0 = done("4i (radix_join_count)", t0)
    dense_in = (pro[1.0][2].key, pro[1.0][2].payload)
    del pro
    flag_cells, flag_build = run_flagship(dev, kind, launches, err)
    torch.cuda.empty_cache()
    t0 = done("4f (BRJ 128M x 1.024B)", t0)
    run_key8b(dev, kind, launches)
    t0 = done("4k (workload A, KEY_8B)", t0)
    sms = run_split.card_sms(dev)
    run_zipf(dev, kind, launches, sms, pro_plans[1.0])
    t0 = done("4l (Zipf PRO 16M x 128M), 4n (group_by_key, "
              "join_group_count)", t0)
    run_ranks_on_one_card()
    t0 = done("4o (4 gloo ranks on one card)", t0)

    times = time_kernels(dev, pro_plans, b_plan, two_pass, bpro, dense_in,
                         mat_plan, gp_parts, err)
    times["bloom_build"] = flag_build
    pass2_widths(dev, two_pass, err)
    cells = [c for label, plan in (("PRO q=1", pro_plans[1.0]),
                                   ("PRO q=0.01", pro_plans[0.01]),
                                   ("4d", two_pass), ("4e", bpro))
             for c in class_cells(label, plan, sms)]
    print("classes: " + "; ".join(cells + flag_cells), flush=True)
    t0 = done("5 (kernel times)", t0)
    del pro_plans, b_plan, two_pass, bpro, dense_in, mat_plan, gp_parts
    torch.cuda.empty_cache()
    run_entry_points()
    t0 = done("6 (entry points: cli, confrun, unittests)", t0)
    quick_rows = run_quick_sweep()
    t0 = done("6b (measurements.run quick sweep)", t0)
    run_tools(quick_rows)
    done("7 (tools: validate_pro, build_check, part_bench, microbench, "
         "validate_key8b; analysis)", t0)
    rows = [{"name": name, "route": route, "source": source,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": err[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": times[name][2],
             "bound_by": times[name][3], "sector_bound_ms":
             times[name][4] if len(times[name]) > 4 else None,
             "library_ms": None,
             "library_note": "no single call: " + NO_LIBRARY_CALL[name]}
            for name, (route, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
