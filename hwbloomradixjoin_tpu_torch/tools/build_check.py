"""The bitmap build (kernel 3) bit for bit against its plain twin, with
the plan's counts and phase times, on the card.

Counterpart of the repository's ``tools/tpu_build_check.py``: a unique R
of 1..|R| in random order and an S uniform over [1, 2|R|) (about half of
it in R), planned by ``bitmap_join.plan_radix_join``:

    python -m hwbloomradixjoin_tpu_torch.tools.build_check [n_r n_s]
    python -m hwbloomradixjoin_tpu_torch.tools.build_check 3000 20000 \\
        --engine-backend cpu

At 2M x 16M by default.  Builds R's bitmap with the plan's build (kernel 3
on the card, over the R partition's starts) and holds it, word for word,
against ``bitmap_join.build_bitmap`` over R's keys at the plan's build
geometry on the same device; then the count over the planned partitions
and the whole join's count against the host's (S keys at most |R|); then
each phase's time and the whole join's (``utils/timing.time_usec``: CUDA
events, warmed, best of 3).  Exits non-zero on a mismatch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from hwbloomradixjoin_tpu_torch.ops import bitmap_join

CHUNK_ROWS = bitmap_join.CHUNK_ROWS     # the planner's chunk


def workload(n_r: int, n_s: int, seed: int = 0):
    """(R keys, S keys, the count) as the JAX tool draws them."""
    rng = np.random.default_rng(seed)
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int32)
    sk = rng.integers(1, 2 * n_r, n_s).astype(np.int32)
    return rk, sk, int((sk <= n_r).sum())


def check(rk, sk, want: int, device) -> dict:
    """The plan of R and S on device, its build against the twin, its
    counts against want: a dict of the plan, the kernel's bitmap, the
    build geometry (part_bits, shift, sl_rows), both counts and ok."""
    lo, hi = 1, len(rk)
    plan = bitmap_join.plan_radix_join(rk, sk, lo, hi, device=device,
                                       chunk_rows=CHUNK_ROWS)
    g = plan.rgeom
    geom = (g.part_bits, g.shift, plan.r_sl_rows)
    bitmap = plan.build(*plan.r_partition())
    twin = bitmap_join.build_bitmap(torch.from_numpy(rk).to(device), lo, hi,
                                    *geom)
    count = int(plan.probe(bitmap, *plan.s_partition(plan.s_effective())))
    full = plan.full_count()
    equal = torch.equal(bitmap, twin)
    return {"plan": plan, "bitmap": bitmap, "geometry": geom,
            "bitmap_equal": equal, "count": count, "full": full,
            "ok": equal and count == full == want}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_r", nargs="?", type=int, default=2_000_000)
    p.add_argument("n_s", nargs="?", type=int, default=16_000_000)
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"])
    a = p.parse_args(argv)
    from hwbloomradixjoin_tpu_torch.cli import device_of
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    dev = device_of(a.engine_backend)
    rk, sk, want = workload(a.n_r, a.n_s)
    got = check(rk, sk, want, dev)
    plan = got["plan"]
    sg = plan.sgeom
    print(f"build check {a.n_r} x {a.n_s} on {dev}: build geometry "
          f"{got['geometry']}, probe ({sg.part_bits}, {sg.shift}, "
          f"{plan.sl_rows}); bitmap {tuple(got['bitmap'].shape)} "
          f"{'equal to' if got['bitmap_equal'] else 'DIFFERS from'} the "
          f"twin's; count={got['count']} full={got['full']} want={want} "
          f"{'OK' if got['ok'] else 'MISMATCH'}", flush=True)
    for name, fn in plan.phase_fns().items():
        us = time_usec(fn, dev)
        per = f" ({us * 1e3 / a.n_r:.4f} ns/R-tuple)" if name == "build" \
            else ""
        print(f"{name}: {us / 1e3:.4f} ms{per}", flush=True)
    us = time_usec(plan.full, dev)
    print(f"full join: {us / 1e3:.4f} ms ({us * 1e3 / a.n_s:.5f} "
          f"ns/S-tuple)", flush=True)
    return 0 if got["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
