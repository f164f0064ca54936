"""Workload A (KEY_8B, 16-byte tuples) through run_join, on the card.

Counterpart of the repository's ``tools/validate_key8b.py``: the
reference's workload A, R 16,777,216 x S 268,435,456 with --enable-key8B
(rerun-experiments.sh:52-60; the reference's PRO_A_8 took 9.61 ns a tuple
on isengard, 3.91 on gondor), as a count query:

    python -m hwbloomradixjoin_tpu_torch.tools.validate_key8b
    python -m hwbloomradixjoin_tpu_torch.tools.validate_key8b \\
        --r 1048576 --s 16777216
    python -m hwbloomradixjoin_tpu_torch.tools.validate_key8b --r 1024 \\
        --s 8192 --engine-backend cpu

R with its stats and payloads; S as the JAX tool builds it, its key words
alone (low words, high words, and a one-element payload placeholder: the
count-only tier reads no S payload).  run_join("PRO", ..., EngineConfig(),
inner_repeats=4) must take the cuda_key8b tier (the JAX tool asserts its
pallas_key8b) and count |S| (q = 1).  Prints the times and exits non-zero
otherwise.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def relations(n_r: int, n_s: int, device):
    """(R, S) of workload A at n_r x n_s on device, S count-only."""
    import torch

    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.types import Relation

    params = G.WorkloadParams(r_size=n_r, s_size=n_s, nthreads=8,
                              key8b=True)
    rk, rp, sk, _ = G.build_workload(params)
    R = Relation.from_numpy(rk, rp, device=device, key8b=True,
                            stats=G.r_key_stats(params))
    sk64 = np.asarray(sk, dtype=np.int64)
    low = (sk64 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    S = Relation(key=torch.from_numpy(low).to(device),
                 key_hi=torch.from_numpy((sk64 >> 32).astype(np.int32))
                 .to(device),
                 payload=torch.zeros(1, dtype=torch.int32, device=device))
    return R, S


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--r", type=int, default=16_777_216)
    p.add_argument("--s", type=int, default=268_435_456)
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"])
    a = p.parse_args(argv)
    from hwbloomradixjoin_tpu_torch.cli import device_of
    from hwbloomradixjoin_tpu_torch.config import EngineConfig
    from hwbloomradixjoin_tpu_torch.models import run_join

    dev = device_of(a.engine_backend)
    print(f"workload A (key8b): {a.r} x {a.s} on {dev}", flush=True)
    t0 = time.perf_counter()
    R, S = relations(a.r, a.s, dev)
    print(f"datagen: {time.perf_counter() - t0:.1f}s", flush=True)
    res, st, _ = run_join("PRO", R, S, EngineConfig(), None,
                          inner_repeats=4)
    ok = st.tier == "cuda_key8b" and res.count() == a.s
    print(f"tier={st.tier} total={st.total_usec / 1e3:.4f} ms "
          f"({st.total_usec * 1e3 / a.s:.5f} ns/tuple) "
          f"build={st.build_usec / 1e3:.4f} ms part={st.part_usec / 1e3:.4f}"
          f" ms probe={st.probe_usec / 1e3:.4f} ms count={res.count()} "
          f"expect={a.s} -> {'OK' if ok else 'MISMATCH'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
