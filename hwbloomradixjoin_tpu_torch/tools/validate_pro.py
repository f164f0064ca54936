"""The PRO bitmap radix join, exact count and times, on the card.

Counterpart of the repository's ``tools/validate_tpu.py``: a unique R of
1..|R| in random order and an S of |S| keys drawn from it (q = 1, so the
count must be |S|), planned by ``bitmap_join.plan_radix_join`` and run at
1M x 8M, then at 16M x 128M:

    python -m hwbloomradixjoin_tpu_torch.tools.validate_pro
    python -m hwbloomradixjoin_tpu_torch.tools.validate_pro \\
        --sizes 2000x16000 --engine-backend cpu

Prints for each size the plan and count, the whole join's time (CUDA
events, warmed, best of 3: ``utils/timing.time_usec``) in ms, ns a tuple
and G rows/s, and each phase's time; exits non-zero if a count is not |S|.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from hwbloomradixjoin_tpu_torch.ops import bitmap_join

SIZES = ((1_000_000, 8_000_000), (16_000_000, 128_000_000))
CHUNK_ROWS = bitmap_join.CHUNK_ROWS     # the planner's chunk


def workload(rng, n_r: int, n_s: int):
    """(R keys, S keys) as the JAX tool draws them: R a permutation of
    1..n_r, S uniform over it."""
    rk = rng.permutation(np.arange(1, n_r + 1)).astype(np.int32)
    sk = rng.integers(1, n_r + 1, n_s).astype(np.int32)
    return rk, sk


def validate(rk, sk, device) -> tuple[bool, str]:
    """Plan and run PRO over R and S on device: (count == |S|, a line)."""
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    n_r, n_s = len(rk), len(sk)
    t0 = time.perf_counter()
    plan = bitmap_join.plan_radix_join(rk, sk, 1, n_r, device=device,
                                       chunk_rows=CHUNK_ROWS)
    got = plan.full_count()
    wall = time.perf_counter() - t0
    ok = got == n_s
    us = time_usec(plan.full, device)
    phases = " ".join(f"{name} {time_usec(fn, device) / 1e3:.4f}"
                      for name, fn in plan.phase_fns().items())
    g = plan.sgeom
    return ok, (f"PRO {n_r} x {n_s}: plan ({g.part_bits}, {g.shift}, "
                f"{plan.sl_rows}) compaction={plan.cap_rows is not None} "
                f"plan+count {wall:.1f}s count={got} want={n_s} "
                f"{'OK' if ok else 'FAIL'}; join {us / 1e3:.4f} ms = "
                f"{us * 1e3 / n_s:.5f} ns/tuple ({n_s / us / 1e3:.2f} G "
                f"rows/s); phases (ms): {phases}")


def parse_sizes(text: str):
    return tuple(tuple(int(float(v)) for v in pair.split("x"))
                 for pair in text.split(","))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sizes", type=parse_sizes, default=SIZES,
                   help="|R|x|S| pairs, comma-separated (default "
                        "1000000x8000000,16000000x128000000)")
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"])
    a = p.parse_args(argv)
    from hwbloomradixjoin_tpu_torch.cli import device_of

    dev = device_of(a.engine_backend)
    rng = np.random.default_rng(0)
    all_ok = True
    for n_r, n_s in a.sizes:
        ok, line = validate(*workload(rng, n_r, n_s), dev)
        all_ok &= ok
        print(line, flush=True)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
