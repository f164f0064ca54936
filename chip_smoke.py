#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root.  Every failure raises (non-zero exit).  Phases:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels (csrc/*.cu, one nvcc per source, in
   parallel) into the package's git-ignored build directory and prints the
   build time;
3. kernel vs twin: each of the seven kernels against its plain PyTorch twin
   on the card on 4 chunks of CHUNK_ROWS=4096 rows: the PRO kernels at
   plan_geometry(1, 16_000_000), the count-table kernels at workload B's
   count geometry plan_geometry_counts(1, 128_000_000) = (13, 14, 128) with
   a non-unique R and an S holding PAD, keys below lo and keys above hi;
   integer outputs must match bit for bit;
4. the PRO path: run_join("PRO") on 16M ⋈ 128M uniform at q=1 and q=0.01;
4b. workload B (128M ⋈ 128M, q=1, payloads on the card): run_join for PRHO,
   PRH and NPO; the tier must be cuda_prho / cuda_prh / cuda_npo, the count
   128,000,000 and the checksums those of the plain ht tier on the same card
   (PRH's S checksum is 0);
4c. PRO over a non-unique build (16M ⋈ 128M, --non-unique generators): the
   tier must be cuda_prho, count and checksums those of the ht tier;
   every run_join above uses allow_dense=False and has the launch counts
   reset just before and read just after; every kernel of its path must
   have launched;
5. kernel and twin times at the main paths' full shapes, where each
   kernel's output must again equal its twin's bit for bit, beside each
   kernel's bound (bytes moved over the card's memory rate).

Prints, in order: the card line, each phase's results and wall time, a
{"kernels": [...]} JSON line, and as the last line {"ok": true, "device":
{...}}.
"""

import json
import subprocess
import time

import numpy as np

R_SIZE = 16_000_000          # the PRO path: 16M ⋈ 128M
S_SIZE = 128_000_000
B_SIZE = 128_000_000          # workload B: 128M ⋈ 128M (BASELINE.md, fig. 11)
NU_R_SIZE = 16_000_000        # non-unique build side, 16M ⋈ 128M
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
}
# The least time the card could take: the larger of the bytes each function
# must move (each input read once, each output written once) over the
# memory rate and its operations over the peak rate, H100 SXM figures of the
# data sheet.  The kernels do scalar int32 work, for which the float32 rate
# outside the tensor cores is the nearest published peak; OPS_PER_ELEM
# counts the integer operations per input element of each function.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
OPS_PER_ELEM = {"partition": 14, "compact": 3, "bitmap_build": 7,
                "bitmap_probe": 9, "partition_kv": 14, "table_build": 8,
                "table_probe": 10}
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
    u = rng.random(n)
    sk = rng.integers(lo, hi + 1, n)
    sk[u < 0.3] = rng.integers(hi + 1, 2**31 - 1, int((u < 0.3).sum()))
    sk[u < 0.05] = rng.integers(-2**31 + 1, lo, int((u < 0.05).sum()))
    sk = sk.astype(np.int32)
    sk[-1000:] = PAD_KEY
    r_in = X._chunk_pad(rk, chunk, dev)
    s_in = torch.from_numpy(sk).to(dev)
    rgeom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=rb, lo=lo, hi=hi,
                        shift=rshift, pad_cat=not X.pad_cat_safe(lo, hi))
    sgeom = X.RadixGeom(chunk_rows=chunk_rows, part_bits=pb, lo=lo, hi=hi,
                        shift=shift)
    for keys, geom in ((r_in, rgeom), (s_in, sgeom)):
        record(err, "partition", X.partition_pass(keys, geom),
               X.partition_pass_plain(keys, geom))
    r_part = X.partition_pass(r_in, rgeom)[0]
    s_part = X.partition_pass(s_in, sgeom)[0]
    for cap in (None, 8, 48):
        record(err, "compact",
               X.compact_pass(s_in, lo, hi, chunk_rows, cap_rows=cap),
               X.compact_pass_plain(s_in, lo, hi, chunk_rows, cap_rows=cap))
    bm = B.bitmap_build(r_part, lo, hi, rb, rshift, rslr)
    record(err, "bitmap_build", bm,
           B.build_bitmap(r_part, lo, hi, rb, rshift, rslr))
    got = B.bitmap_probe_count(bm, s_part, lo, shift, pb, slr)
    record(err, "bitmap_probe", got,
           B.bitmap_probe_count_plain(bm, s_part, lo, shift, pb, slr))
    truth = int(np.isin(sk[(sk >= lo) & (sk <= hi)], rk).sum())
    if int(got) != truth:
        raise AssertionError(f"probe count {int(got)} != numpy {truth}")
    print(f"kernel vs twin: bit-exact at geometry probe {(pb, shift, slr)} "
          f"build {(rb, rshift, rslr)}, {nchunks} chunks of {chunk} keys, "
          f"probe count {truth}", flush=True)


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
    tables = P.table_build(*tb_args)
    record(err, "table_build", tables, P.build_tables(*tb_args))
    sums = {}
    for with_sp in (True, False):
        args = (*tables, s_part[0], s_part[1] if with_sp else None, lo, shift,
                pb, slr)
        sums[with_sp] = P.probe_count_sums(*args)
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


def drive(algo, R, S, cfg, must, label, kind):
    """run_join with the launch counts reset just before and read just
    after; every kernel in `must` has to have launched.  Returns
    (result, stats, sums, launches)."""
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.models import run_join

    _build.reset_launches()
    res, st, sums = run_join(algo, R, S, cfg, inner_repeats=4)
    ran = dict(_build.LAUNCHES)
    missing = [k for k in must if ran[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels never launched: {missing}")
    phases = " ".join(f"{k}={v / 1e3:.4f}ms" for k, v in st.phases.items())
    print(f"{label} on {kind}: tier={st.tier} count={res.count()} "
          f"sums={sums} total={st.total_usec / 1e3:.4f}ms "
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
    plan of the same inputs for kernel timing."""
    import torch
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join
    from hwbloomradixjoin_tpu_torch.types import Relation

    params = G.WorkloadParams(r_size=R_SIZE, s_size=S_SIZE, nthreads=8,
                              selectivity=q)
    rk, rp, sk, _ = G.build_workload(params)
    pad = (-len(sk)) % (bitmap_join.CHUNK_ROWS * 128)
    sk = np.concatenate([sk, np.full(pad, PAD_KEY, np.int32)])
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    # key-column projection: the count-only radix tier never reads S.payload
    S = Relation(key=torch.from_numpy(sk).to(dev),
                 payload=torch.zeros(1, dtype=torch.int32, device=dev))
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
    return bitmap_join.plan_radix_join(R.key, S.key, 1, R_SIZE, device=dev)


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
    Returns the PRHO plan of the same inputs for kernel timing."""
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
    return prho_join.plan_prho_join(R.key, R.payload, S.key, S.payload, 1,
                                    B_SIZE, device=dev)


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def time_kernels(dev, pro_plans, b_plan, err) -> dict:
    """Phase 5: name -> (kernel ms, twin ms, bound ms, bound_by) at the main
    paths' full shapes: PRO's partition and probe of S at q=1, compaction
    of S at q=0.01, build of R; workload B's partition of S with payloads,
    table build from R and probe of S with payloads.  Each kernel's output
    there must equal its twin's bit for bit (folded into err)."""
    import torch
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import prho_join as P
    from hwbloomradixjoin_tpu_torch.ops import radix as X
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    p1, p2 = pro_plans[1.0], pro_plans[0.01]
    m = p1._intermediates()
    g, rg = p1.sgeom, p1.rgeom
    build_args = (m["r_part"], 1, R_SIZE, rg.part_bits, rg.shift, p1.r_sl_rows)
    probe_args = (m["bitmap"], m["s_part"], 1, g.shift, g.part_bits, p1.sl_rows)
    compact_args = (p2.sk_in, 1, R_SIZE, g.chunk_rows, p2.cap_rows)
    mb = b_plan._intermediates()
    gb, slr = b_plan.geom, b_plan.slice_rows
    r_kv, tables, s_kv = mb["r_part"], mb["tables"], mb["s_part"]
    tb_args = (r_kv[0], r_kv[1], 1, B_SIZE, gb.part_bits, gb.shift, slr)
    pr_args = (*tables, *s_kv, 1, gb.shift, gb.part_bits, slr)
    keys = s_kv[0].reshape(-1)
    live = keys[(keys >= 1) & (keys < 1 + ((1 << gb.part_bits) << gb.shift))]
    slots_needed = torch.unique(live).numel()
    del keys, live
    # name -> (kernel, twin, bytes read, input elements)
    pairs = {
        "partition": (lambda: X.partition_pass(p1.sk_in, g),
                      lambda: X.partition_pass_plain(p1.sk_in, g),
                      nbytes(p1.sk_in), p1.sk_in.numel()),
        "compact": (lambda: X.compact_pass(*compact_args),
                    lambda: X.compact_pass_plain(*compact_args),
                    nbytes(p2.sk_in), p2.sk_in.numel()),
        "bitmap_build": (lambda: B.bitmap_build(*build_args),
                         lambda: B.build_bitmap(*build_args),
                         nbytes(m["r_part"]), m["r_part"].numel()),
        # at q=1 S covers R's whole key range, so it needs every bitmap word
        "bitmap_probe": (lambda: B.bitmap_probe_count(*probe_args),
                         lambda: B.bitmap_probe_count_plain(*probe_args),
                         nbytes(m["s_part"], m["bitmap"]),
                         m["s_part"].numel()),
        "partition_kv": (
            lambda: X.partition_pass_kv(b_plan.sk_in, b_plan.sp_in, gb),
            lambda: X.partition_pass_kv_plain(b_plan.sk_in, b_plan.sp_in, gb),
            nbytes(b_plan.sk_in, b_plan.sp_in), b_plan.sk_in.numel()),
        "table_build": (lambda: P.table_build(*tb_args),
                        lambda: P.build_tables(*tb_args),
                        nbytes(*r_kv[:2]), r_kv[0].numel()),
        # the probe needs S's two columns and the two 4-byte slots of each
        # distinct in-range S key
        "table_probe": (lambda: P.probe_count_sums(*pr_args),
                        lambda: P.probe_count_sums_plain(*pr_args),
                        nbytes(*s_kv) + 8 * slots_needed, s_kv[0].numel()),
    }
    times = {}
    for name, (kern, plain, read, elems) in pairs.items():
        ms = time_usec(kern, dev) / 1e3
        plain_ms = time_usec(plain, dev) / 1e3
        got, want = kern(), plain()
        record(err, name, got, want)
        written = nbytes(*(got if isinstance(got, tuple) else (got,)))
        t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
        t_ops = elems * OPS_PER_ELEM[name] / SCALAR_OPS_PER_S * 1e3
        times[name] = (ms, plain_ms, max(t_bytes, t_ops),
                       "bytes" if t_bytes >= t_ops else "operations")
        print(f"{name}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, bound "
              f"{times[name][2]:.4f} ms ({read + written} bytes)", flush=True)
    keys_only = (*tables, s_kv[0], None, 1, gb.shift, gb.part_bits, slr)
    record(err, "table_probe", P.probe_count_sums(*keys_only),
           P.probe_count_sums_plain(*keys_only))
    print("kernel vs twin: bit-exact at the main paths' full shapes",
          flush=True)
    return times


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    from hwbloomradixjoin_tpu_torch.kernels import _build

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

    launches = {k: 0 for k in KERNELS}
    pro_plans = {q: run_pro_path(dev, q, kind, launches) for q in (1.0, 0.01)}
    t0 = done("4 (PRO 16M x 128M)", t0)
    b_plan = run_workload_b(dev, kind, launches)
    t0 = done("4b (workload B)", t0)
    run_nonunique(dev, kind, launches)
    t0 = done("4c (non-unique build)", t0)

    times = time_kernels(dev, pro_plans, b_plan, err)
    done("5 (kernel times)", t0)
    rows = [{"name": name, "route": route, "source": source,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": err[name], "ms": times[name][0],
             "plain_ms": times[name][1], "bound_ms": times[name][2],
             "bound_by": times[name][3], "library_ms": None,
             "library_note": "no single call: " + NO_LIBRARY_CALL[name]}
            for name, (route, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
