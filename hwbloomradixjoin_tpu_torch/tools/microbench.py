"""The card's primitives, timed: the building blocks the join is made of.

Counterpart of the repository's ``tools/microbench.py``, which timed XLA's
primitives on its chip: the same list as PyTorch calls on the card, at
its sizes (N = 128M keys, NR = 16M build keys):

    python -m hwbloomradixjoin_tpu_torch.tools.microbench
    python -m hwbloomradixjoin_tpu_torch.tools.microbench --n 4096 \\
        --nr 1024 --engine-backend cpu

the launch latency of a trivial op (in place of the JAX tool's dispatch
floor), a stream copy and a reduce of N int32, gathers of N from an NR
table and from a 128K table, scatter-adds of NR and of N into NR slots,
``torch.sort`` of NR and of N, a key-payload sort of N (the sort, then the
payloads gathered by its order) and kernel 1 (``radix.partition_pass``)
at ``bitmap_join.plan_geometry(1, NR)`` over NR keys, 8 passes
back-to-back.  Each is timed with ``utils/timing.time_usec`` (CUDA
events, warmed, best of 3) and printed in ms, GB/s of the bytes it must
move (each input read once, each output written once), the share of the
card's data-sheet HBM rate (3.35 TB/s on the H100) and G elem/s.  These
are library calls on purpose: this tool measures the card's primitives,
and no join path calls them.  Before timing, each result is checked once
(the sum against the host's, every scatter-add count, the sort's order,
the gathers' first keys, kernel 1's first chunk against its twin);
a mismatch exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hwbloomradixjoin_tpu_torch.ops import bitmap_join
from hwbloomradixjoin_tpu_torch.ops import radix as radix_ops
from hwbloomradixjoin_tpu_torch.tools import part_bench

CHUNK_ROWS = bitmap_join.CHUNK_ROWS     # the planner's chunk
SMALL_TABLE = 131072        # the 128K table of the second gather
PART_PASSES = 8             # kernel 1's back-to-back passes


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"microbench: {what}")


def line(name: str, us: float, nbytes: int | None, elems: int | None,
         hbm: float | None) -> str:
    out = f"{name:40s} {us / 1e3:10.5f} ms"
    if nbytes:
        out += f"  {nbytes / us / 1e3:8.1f} GB/s"
        if hbm:
            out += f" ({nbytes / (us * 1e-6) / hbm * 100:5.1f} % of " \
                   f"{hbm / 1e12:.2f} TB/s)"
    if elems:
        out += f"  {elems / us / 1e3:7.3f} G elem/s"
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=128_000_000)
    p.add_argument("--nr", type=int, default=16_000_000)
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"])
    a = p.parse_args(argv)
    from hwbloomradixjoin_tpu_torch.cli import device_of
    from hwbloomradixjoin_tpu_torch.utils import roofline
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    dev = device_of(a.engine_backend)
    n, nr = a.n, a.nr
    hbm = None
    if dev.type == "cuda":
        chip = roofline.chip_model()
        hbm = None if chip is None else chip.hbm_bytes_per_s
        print(f"microbench on {roofline.card_line()}; L2 "
              f"{torch.cuda.get_device_properties(dev).L2_cache_size} bytes",
              flush=True)
    else:
        print("microbench on cpu: host-clock times of the CPU's ops, no "
              "device metric", flush=True)

    def run(name, fn, nbytes=None, elems=None, calls=1):
        us = time_usec(fn, dev, calls)
        print(line(name, us, nbytes, elems, hbm), flush=True)
        return us

    rng = np.random.default_rng(0)
    sk_h = rng.integers(1, nr + 1, n).astype(np.int32)
    sk = torch.from_numpy(sk_h).to(dev)
    rk = torch.from_numpy(rng.permutation(np.arange(1, nr + 1))
                          .astype(np.int32)).to(dev)

    one = torch.zeros(1, dtype=torch.int32, device=dev)
    run("launch latency (add_ on one int32)", lambda: one.add_(1),
        calls=1000)

    out = torch.empty_like(sk)
    run(f"stream copy {n} i32", lambda: out.copy_(sk), 2 * 4 * n, n)
    _check(int(sk.sum()) == int(sk_h.sum(dtype=np.int64)), "sum")
    run(f"reduce sum {n} i32", lambda: sk.sum(), 4 * n, n)

    tbl_h = rng.integers(0, 100, nr + 2).astype(np.int32)
    tbl = torch.from_numpy(tbl_h).to(dev)
    _check(np.array_equal(torch.index_select(tbl, 0, sk[:1024]).cpu()
                          .numpy(), tbl_h[sk_h[:1024]]), "gather")
    run(f"gather {n} from {nr + 2} tbl",
        lambda: torch.index_select(tbl, 0, sk), 2 * 4 * n, n)
    ski = torch.from_numpy(rng.integers(0, SMALL_TABLE, n)
                           .astype(np.int32)).to(dev)
    tbl2 = torch.from_numpy(rng.integers(0, 100, SMALL_TABLE)
                            .astype(np.int32)).to(dev)
    run(f"gather {n} from {SMALL_TABLE} tbl",
        lambda: torch.index_select(tbl2, 0, ski), 2 * 4 * n, n)
    del ski, tbl2

    ones = torch.ones(n, dtype=torch.int32, device=dev)

    def scatter(keys):
        return torch.zeros(nr + 2, dtype=torch.int32, device=dev) \
            .index_add_(0, keys, ones[:keys.numel()])
    counts = scatter(rk)
    _check(bool((counts[1:nr + 1] == 1).all()) and int(counts.sum()) == nr,
           "scatter-add of R")
    _check(int(scatter(sk).sum()) == n, "scatter-add of S")
    run(f"scatter-add {nr} into {nr + 2}", lambda: scatter(rk),
        2 * 4 * nr + 4 * (nr + 2), nr)
    run(f"scatter-add {n} into {nr + 2}", lambda: scatter(sk),
        2 * 4 * n + 4 * (nr + 2), n)
    del counts

    srt = torch.sort(sk).values
    _check(bool((srt[1:] >= srt[:-1]).all()) and int(srt.sum()) == int(
        sk_h.sum(dtype=np.int64)), "sort")
    del srt
    # torch.sort writes the values and their int64 source positions
    run(f"sort {nr} i32", lambda: torch.sort(rk), nr * (4 + 4 + 8), nr)
    run(f"sort {n} i32", lambda: torch.sort(sk), n * (4 + 4 + 8), n)

    def sort_kv():
        v, order = torch.sort(sk, stable=True)
        return v, torch.index_select(sk, 0, order)
    run(f"sort {n} kv (sort + payload gather)", sort_kv,
        n * (4 + 4 + 4 + 4), n)
    del out, ones

    part_bits, shift, sl_rows = bitmap_join.plan_geometry(1, nr)
    geom = radix_ops.RadixGeom(chunk_rows=CHUNK_ROWS, part_bits=part_bits,
                               lo=1, hi=nr, shift=shift)
    keys = radix_ops._chunk_pad(sk[:nr], CHUNK_ROWS * radix_ops.LANES, dev)
    print(f"geom: part_bits={part_bits} shift={shift} sl_rows={sl_rows}",
          flush=True)
    _check(part_bench.first_chunk_matches(keys, geom),
           "partition_pass' first chunk against its twin")
    run(f"partition_pass {nr} keys, a pass of {PART_PASSES}",
        lambda: radix_ops.partition_pass(keys, geom), 2 * 4 * keys.numel(),
        nr, calls=PART_PASSES)
    return 0


if __name__ == "__main__":
    sys.exit(main())
