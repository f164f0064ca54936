"""Launch a world of processes that run the distributed join, and check it.

Counterpart of the JAX package's ``tools/dist_multiproc.py`` and
``__graft_entry__.dryrun_multichip``: N processes joined through the HBRJ_*
environment (``mesh.init_distributed``) run ``dist_join_count`` over
subgroups of the world and rank 0 writes their results; the parent checks
them against ``native.ref_join`` and the host filter.  The children import
torch and this package only.

    python -m hwbloomradixjoin_tpu_torch.parallel.multiproc --procs 4 \\
        --device cpu

runs the dry run (the uniform join through the blocked filter, a heavy key
with skew handling, the bitmap engine, and a Zipf S with and without skew
handling) on N gloo processes; ``--device cuda --backend gloo`` runs the N
processes on one card (NCCL takes one process a card).  It ends with
"MULTIPROC PASS" or raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def case(name: str, n_dev: int, workload: dict, repeats: int = 1,
         **kw) -> dict:
    """One distributed join: its name, mesh size, workload (workload()'s
    spec), the runs whose best host time is kept, and dist_join_count's
    keywords (bloom as BloomArgs' fields)."""
    return {"name": name, "n_dev": n_dev, "workload": workload,
            "repeats": repeats, "kw": kw}


def workload(spec: dict):
    """(rk, rp, sk, sp) of a spec: WorkloadParams' fields, and optionally
    "heavy_key": [key, share, seed], which overwrites that share of S's
    rows, chosen by the seed, with one key."""
    from hwbloomradixjoin_tpu_torch.data import generator as G
    spec = dict(spec)
    heavy = spec.pop("heavy_key", None)
    rk, rp, sk, sp = G.build_workload(G.WorkloadParams(**spec))
    if heavy is not None:
        key, share, seed = heavy
        rows = np.random.default_rng(seed).choice(
            sk.shape[0], int(sk.shape[0] * share), replace=False)
        sk = sk.copy()
        sk[rows] = key
    return rk, rp, sk, sp


def _bloom_args(kw: dict):
    from hwbloomradixjoin_tpu_torch.config import BloomArgs, BloomVariant
    b = kw.get("bloom")
    if b is None:
        return None
    return BloomArgs(**{**b, "variant": BloomVariant(b["variant"])})


def child(spec_path: str, out_path: str, device: str, backend) -> int:
    """A rank: join the world, run every case whose mesh holds this rank,
    and, on rank 0, write the results."""
    import torch
    import torch.distributed as dist
    from hwbloomradixjoin_tpu_torch.parallel import dist_join, mesh

    if not mesh.init_distributed(device, backend):
        raise RuntimeError("HBRJ_COORDINATOR is not set: start the ranks "
                           "through multiproc.run_world")
    try:
        cases = json.loads(Path(spec_path).read_text())
        groups, data, results = {}, {}, []
        for c in cases:
            n = c["n_dev"]
            if n not in groups:         # every rank creates every group
                groups[n] = mesh.make_mesh(n, device)
            if not mesh.in_mesh(groups[n]):
                continue
            key = json.dumps(c["workload"], sort_keys=True)
            if key not in data:
                data[key] = workload(c["workload"])
            kw = {k: v for k, v in c["kw"].items() if k != "bloom"}
            plan = dist_join.plan_dist_join(
                groups[n], *data[key], bloom_args=_bloom_args(c["kw"]),
                device=device, **kw)
            best = None
            for _ in range(c.get("repeats", 1)):
                t0 = time.perf_counter()
                out = [int(v) for v in plan.run()]
                dt = time.perf_counter() - t0
                best = dt if best is None else min(best, dt)
            results.append({"name": c["name"], "n_dev": n,
                            "outputs": out, "seconds": best})
        if dist.get_rank() == 0:
            jax = [m for m in sys.modules
                   if m.split(".")[0] in ("jax", "hwbloomradixjoin_tpu")]
            Path(out_path).write_text(json.dumps(
                {"results": results, "jax_modules": jax,
                 "device": str(torch.device(device)),
                 "backend": dist.get_backend()}))
    finally:
        dist.destroy_process_group()
    return 0


def run_world(nproc: int, cases: list, device: str = "cuda",
              backend: str | None = None, timeout: float = 600.0) -> dict:
    """Run the cases on a world of nproc processes; rank 0's record:
    {"results": [{"name", "n_dev", "outputs": [count, sum_r, sum_s,
    s_after, overflow], "seconds": the best run's host time}],
    "jax_modules", "device", "backend"}.

    The kernels and the native generators are built here first, so the
    ranks do not race on the build directory.  Raises, with every rank's
    output, if a rank fails or outlives the timeout; every rank is stopped.
    """
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.parallel import mesh

    native.lib()
    if device.startswith("cuda"):
        from hwbloomradixjoin_tpu_torch.kernels import _build
        _build.lib()
    address = mesh.free_address()
    with tempfile.TemporaryDirectory() as tmp:
        spec, out = os.path.join(tmp, "cases.json"), os.path.join(tmp,
                                                                  "out.json")
        Path(spec).write_text(json.dumps(cases))
        procs = []
        for rank in range(nproc):
            env = {**os.environ, "HBRJ_COORDINATOR": address,
                   "HBRJ_NUM_PROCS": str(nproc), "HBRJ_PROC_ID": str(rank),
                   "PYTHONPATH": os.pathsep.join(
                       [str(REPO), os.environ.get("PYTHONPATH", "")])}
            if not device.startswith("cuda"):
                env.setdefault("OMP_NUM_THREADS", "1")
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "hwbloomradixjoin_tpu_torch.parallel.multiproc", "--child",
                 spec, out, device, backend or ""], cwd=REPO, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], False
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                logs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(p.communicate()[0])
                failed = True
            failed |= p.returncode != 0
        if failed or not os.path.exists(out):
            for q in procs:
                q.kill()
                q.wait()
            raise RuntimeError("multiproc world failed:\n" + "\n".join(
                f"--- rank {i} (rc={p.returncode}) ---\n{log}"
                for i, (p, log) in enumerate(zip(procs, logs))))
        return json.loads(Path(out).read_text())


def dryrun_cases(n_dev: int, r_size: int, s_size: int, m: int,
                 zipf: bool) -> list:
    """The dry run's joins: the uniform join (selectivity 0.4) through a
    blocked filter (k = 2, B = 512, m bits), a key on half of S with skew
    handling, the bitmap engine, and, with zipf, an S Zipf z = 1.0 over R's
    keys with skew handling (pad factor 3) and without it."""
    uniform = {"r_size": r_size, "s_size": s_size, "nthreads": 4,
               "selectivity": 0.4}
    cases = [
        case("filtered", n_dev, uniform,
             bloom={"variant": "blocked", "m": m, "k": 2, "B": 512}),
        case("heavy_key", n_dev, {**uniform, "heavy_key": [7, 0.5, 1]},
             skew_handling=True),
        case("pallas", n_dev, uniform, local_engine="pallas",
             key_range=[1, r_size])]
    if zipf:
        z = {"r_size": r_size, "s_size": s_size, "nthreads": 4, "skew": 1.0}
        cases += [case("zipf_skew", n_dev, z, pad_factor=3.0,
                       skew_handling=True),
                  case("zipf", n_dev, z)]
    return cases


def expected(c: dict):
    """(count, R checksum, S checksum, S after the filter) of a case from
    native.ref_join and the host filter; the sums mod 2^32, the survivors
    -1 without a filter."""
    from hwbloomradixjoin_tpu_torch.data import native
    from hwbloomradixjoin_tpu_torch.ops import bloom

    rk, rp, sk, sp = workload(c["workload"])
    cnt, sr, ss = native.ref_join(rk, rp, sk, sp)
    args = _bloom_args(c["kw"])
    after = -1 if args is None else int(bloom.probe_bitmap_host(
        bloom.build_bitmap_host(rk, args), sk, args).sum())
    return cnt, sr % 2**32, ss % 2**32, after


def dryrun(nproc: int, device: str = "cuda", backend: str | None = None,
           r_size: int = 1 << 14, s_size: int = 1 << 17, m: int = 1 << 18,
           zipf: bool = True) -> list:
    """The dry run on nproc processes, the mesh their whole world: each
    join's count, checksums (the sort-scan engine's) and survivors equal
    the host's, with no overflow.  Prints a line a join and MULTIPROC PASS;
    raises on a mismatch.  Returns rank 0's results."""
    cases = dryrun_cases(nproc, r_size, s_size, m, zipf)
    rec = run_world(nproc, cases, device, backend)
    if rec["jax_modules"]:
        raise AssertionError(f"a rank imported {rec['jax_modules']}")
    for c, r in zip(cases, rec["results"]):
        cnt, sr, ss, after = expected(c)
        got = r["outputs"]
        want = [cnt, 0, 0, after, 0] if c["kw"].get("local_engine") \
            == "pallas" else [cnt, sr, ss, after, 0]
        print(f"[multiproc] {c['name']} D={r['n_dev']} on {rec['device']} "
              f"({rec['backend']}): count={got[0]} sums={got[1:3]} "
              f"s_after={got[3]} overflow={got[4]} expected={want} "
              f"{r['seconds']:.3f}s host", flush=True)
        if got != want:
            raise AssertionError(f"{c['name']}: {got} != {want}")
    print(f"MULTIPROC PASS ({nproc} processes)", flush=True)
    return rec["results"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--child", nargs=4, metavar=("SPEC", "OUT", "DEVICE",
                                                "BACKEND"),
                   help=argparse.SUPPRESS)
    p.add_argument("--procs", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    p.add_argument("--r-size", type=int, default=1 << 14)
    p.add_argument("--s-size", type=int, default=1 << 17)
    p.add_argument("--bloom-size", type=int, default=1 << 18)
    args = p.parse_args(argv)
    if args.child:
        spec, out, device, backend = args.child
        return child(spec, out, device, backend or None)
    dryrun(args.procs, args.device, args.backend, args.r_size, args.s_size,
           args.bloom_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
