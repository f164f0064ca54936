#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the repository root.  Every failure raises (non-zero exit).  Phases:

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles the kernels (csrc/*.cu) with nvcc into the package's
   git-ignored build directory and prints the build time;
3. kernel vs twin: each of the four kernels against its plain PyTorch twin on
   the card at the main path's geometry (CHUNK_ROWS=4096, a few chunks,
   plan_geometry(1, 16_000_000), S with PAD and out-of-range keys); integer
   outputs must match bit for bit;
4. main path: run_join("PRO") on 16M ⋈ 128M uniform at q=1 and q=0.01
   (allow_dense=False), launch counts reset just before and read just
   after; the count must be exact, the tier cuda_radix, and every kernel of
   the path launched;
5. kernel and twin times at the main path's full shapes, where each
   kernel's output must again equal its twin's bit for bit.

Prints, in order: the card line, per-run results, a {"kernels": [...]} JSON
line, and as the last line {"ok": true, "device": {...}}.
"""

import json
import subprocess
import time

import numpy as np

R_SIZE = 16_000_000
S_SIZE = 128_000_000
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
}


def max_abs_err(got, want) -> int:
    """Largest absolute difference of two integer results (0 = bit-exact)."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    return int((got.long() - want.long()).abs().max())


def compare_kernels(dev, rng) -> dict:
    """Phase 3: every kernel against its twin, on the card, same inputs."""
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
    err = {}

    def same(name, got, want):
        e = max_abs_err(got, want)
        err[name] = max(err.get(name, 0), e)
        if e:
            raise AssertionError(f"{name}: kernel differs from twin by {e}")

    for keys, geom in ((r_in, rgeom), (s_in, sgeom)):
        got, want = X.partition_pass(keys, geom), X.partition_pass_plain(keys, geom)
        same("partition", got[0], want[0])
        same("partition", got[1], want[1])
    r_part = X.partition_pass(r_in, rgeom)[0]
    s_part = X.partition_pass(s_in, sgeom)[0]
    for cap in (None, 8, 48):
        got = X.compact_pass(s_in, lo, hi, chunk_rows, cap_rows=cap)
        want = X.compact_pass_plain(s_in, lo, hi, chunk_rows, cap_rows=cap)
        same("compact", got[0], want[0])
        same("compact", got[1], want[1])
    bm = B.bitmap_build(r_part, lo, hi, rb, rshift, rslr)
    same("bitmap_build", bm, B.build_bitmap(r_part, lo, hi, rb, rshift, rslr))
    got = B.bitmap_probe_count(bm, s_part, lo, shift, pb, slr)
    want = B.bitmap_probe_count_plain(bm, s_part, lo, shift, pb, slr)
    same("bitmap_probe", got, want)
    truth = int(np.isin(sk[(sk >= lo) & (sk <= hi)], rk).sum())
    if int(got) != truth:
        raise AssertionError(f"probe count {int(got)} != numpy {truth}")
    print(f"kernel vs twin: bit-exact at geometry probe {(pb, shift, slr)} "
          f"build {(rb, rshift, rslr)}, {nchunks} chunks of {chunk} keys, "
          f"probe count {truth}", flush=True)
    return err


def make_relations(dev, q: float):
    import torch
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join
    from hwbloomradixjoin_tpu_torch.types import Relation

    params = G.WorkloadParams(r_size=R_SIZE, s_size=S_SIZE, nthreads=8,
                              selectivity=q)
    rk, rp, sk, _ = G.build_workload(params)
    pad = (-len(sk)) % (bitmap_join.CHUNK_ROWS * 128)
    sk = np.concatenate([sk, np.full(pad, PAD_KEY, np.int32)])
    R = Relation.from_numpy(rk, rp, device=dev, stats=G.r_key_stats(params))
    S = Relation(key=torch.from_numpy(sk).to(dev),
                 payload=torch.zeros(1, dtype=torch.int32, device=dev))
    return R, S, G.expected_uniform_match_count(S_SIZE, q)


def run_main_path(dev, q: float):
    """Phase 4, one selectivity: run_join("PRO") with the launch counts reset
    just before and read just after.  Returns (result, stats, launches,
    expected count, plan of the same inputs for kernel timing)."""
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.kernels import _build
    from hwbloomradixjoin_tpu_torch.models import run_join
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join

    R, S, expect = make_relations(dev, q)
    _build.reset_launches()
    res, st, _ = run_join("PRO", R, S, EngineConfig(allow_dense=False),
                          inner_repeats=4)
    ran = dict(_build.LAUNCHES)
    plan = bitmap_join.plan_radix_join(R.key, S.key, 1, R_SIZE, device=dev)
    return res, st, ran, expect, plan


def time_kernels(dev, plans, err) -> dict:
    """Phase 5: name -> (kernel ms, twin ms) at the main path's full shapes:
    partition and probe of S at q=1, compaction of S at q=0.01, build of R.
    Each kernel's output there must equal its twin's bit for bit; the
    difference is folded into err[name]."""
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
    from hwbloomradixjoin_tpu_torch.ops import radix as X
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    p1, p2 = plans[1.0], plans[0.01]
    m = p1._intermediates()
    g, rg = p1.sgeom, p1.rgeom
    build_args = (m["r_part"], 1, R_SIZE, rg.part_bits, rg.shift, p1.r_sl_rows)
    probe_args = (m["bitmap"], m["s_part"], 1, g.shift, g.part_bits, p1.sl_rows)
    compact_args = (p2.sk_in, 1, R_SIZE, g.chunk_rows, p2.cap_rows)
    pairs = {
        "partition": (lambda: X.partition_pass(p1.sk_in, g),
                      lambda: X.partition_pass_plain(p1.sk_in, g)),
        "compact": (lambda: X.compact_pass(*compact_args),
                    lambda: X.compact_pass_plain(*compact_args)),
        "bitmap_build": (lambda: B.bitmap_build(*build_args),
                         lambda: B.build_bitmap(*build_args)),
        "bitmap_probe": (lambda: B.bitmap_probe_count(*probe_args),
                         lambda: B.bitmap_probe_count_plain(*probe_args)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        times[name] = (time_usec(kern, dev) / 1e3, time_usec(plain, dev) / 1e3)
        got, want = kern(), plain()
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        err[name] = max(err[name], e)
        if e:
            raise AssertionError(f"{name}: kernel differs from twin by {e} "
                                 "at the main path's shapes")
    print("kernel vs twin: bit-exact at the main path's full shapes",
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

    err = compare_kernels(dev, np.random.default_rng(2026))

    launches = {k: 0 for k in KERNELS}
    plans = {}
    for q, must in ((1.0, ("partition", "bitmap_build", "bitmap_probe")),
                    (0.01, ("compact",))):
        res, st, ran, expect, plans[q] = run_main_path(dev, q)
        if st.tier != "cuda_radix":
            raise AssertionError(f"q={q}: tier {st.tier} != cuda_radix")
        if res.count() != expect:
            raise AssertionError(f"q={q}: count {res.count()} != {expect}")
        missing = [k for k in must if ran[k] == 0]
        if missing:
            raise AssertionError(f"q={q}: kernels never launched: {missing}")
        for k in launches:
            launches[k] += ran[k]
        phases = " ".join(f"{k}={v / 1e3:.4f}ms" for k, v in st.phases.items())
        print(f"main path q={q} on {kind}: tier={st.tier} count={res.count()} "
              f"total={st.total_usec / 1e3:.4f}ms "
              f"ns/S-tuple={st.total_usec * 1e3 / S_SIZE:.5f} {phases} "
              f"launches={ran}", flush=True)

    times = time_kernels(dev, plans, err)
    rows = [{"name": name, "route": route, "source": source,
             "replaces": replaces, "launches": launches[name],
             "max_abs_err": err[name], "ms": times[name][0],
             "plain_ms": times[name][1]}
            for name, (route, source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
