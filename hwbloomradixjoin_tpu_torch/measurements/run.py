"""Sweep driver over the port's command line.

Counterpart of the repository's ``measurements/run.py``.  Each sweep runs
the port's CLI (``python -m hwbloomradixjoin_tpu_torch.cli``) as a
subprocess per configuration, parses its stdout with ``parse_result`` (the
reference's parse, which reads either engine's timing block) and saves the
rows as JSON lines and a markdown table, with no pandas:

    python -m hwbloomradixjoin_tpu_torch.measurements.run quick
    python -m hwbloomradixjoin_tpu_torch.measurements.run params \\
        --engine-backend cpu
    python -m hwbloomradixjoin_tpu_torch.measurements.run zipf --out DIR

Sweeps: quick, bloom (basic vs blocked x k), params (|R| x S:R x q),
radix_bits (PRO and PRHO over the fan-out at workload B), never_single_pass
(fan-out x filter x k), passes (1 vs 2), algos and algos_b (PRO / PRH /
PRHO / NPO at 1M x 8M and at workload B), zipf (PRO over a Zipf S at each
z, beside group_by_key over the same S, run in this process), and scaling
and dist_bloom: the distributed join on N gloo ranks through
``parallel/multiproc.py``'s launcher, on the CPU with --engine-backend cpu
and else sharing the card, whose times are host times of processes
sharing one machine (their counts, survivors and exchange bytes are the
result).

Every row holds its configuration, the parsed stdout, the tier (the CLI
runs with --engine-sync-stats), the expected count where the workload
fixes it, whether the count is exact and the device it ran on (the
card's name and power limit, or cpu).  Output: <out>/<name>.jsonl and
<name>.md, by default chiprun_out/sweeps/ under the repository root
(git-ignored).  The card runs every join unless --engine-backend cpu is
given; without a card the driver raises.  Sizes are overridden as in the
JAX harness: HBRJ_SWEEP_R, HBRJ_SWEEP_S, HBRJ_SWEEP_INNER, HBRJ_SWEEP_M,
HBRJ_SWEEP_KS, HBRJ_SWEEP_RSIZES, HBRJ_SWEEP_BITS.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import itertools
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

from hwbloomradixjoin_tpu_torch.measurements.config import (CLI_MODULE,
                                                            JoinConfig)
from hwbloomradixjoin_tpu_torch.utils.roofline import card_line

REPO = Path(__file__).resolve().parents[2]
OUT_DIR = REPO / "chiprun_out" / "sweeps"
WORKLOAD_B = 128_000_000        # figure 11's 128M x 128M
ZIPF_ZS = (0.75, 1.0, 1.25)     # the zipf sweep's -z values


def parse_result(res: str) -> dict:
    """Parse the reference's stdout (the reference's parse_result).

    A filter that keeps no tuple gives filtered-pct 0.0; None only where
    the run printed no filter line."""
    s_size = int(re.search(
        r"relation S with size = [\d.]+ MiB, #tuples = (\d+) : OK", res).group(1))
    filtered = re.search(r"S-tuples after filter: (\d+)\n", res)
    filtered = int(filtered.group(1)) if filtered else None
    runtime, build, part = re.search(
        r"RUNTIME TOTAL, BUILD, PART \(cycles\):\s+(\d+)\s+(\d+)\s+(\d+)",
        res).groups()
    usecs, out_tuples, nsec = re.search(
        r"TOTAL-TIME-USECS, TOTAL-TUPLES, NSEC-PER-TUPLE:\s+([\d.]+)\s+(\d+)\s+([\d.]+)",
        res).groups()
    part_us, probe_us, join_us = re.search(
        r"PARTITION-TIME-USECS, PROBE-TIME-USECS, JOIN-TIME-USECS:\s+([\d.]+)\s+([\d.]+)\s+([\d.]+)",
        res).groups()
    results = re.search(r"Results = (\d+)\. DONE", res)
    return {
        "s-size": s_size,
        "filtered": filtered,
        "filtered-pct": None if filtered is None
        else filtered / s_size * 100,
        "runtime-cycles": int(runtime),
        "build-cycles": int(build),
        "part-cycles": int(part),
        "time-usecs": float(usecs),
        "out-tuples": int(out_tuples),
        "nsec-per-tuple": float(nsec),
        "partition-usecs": float(part_us),
        "probe-usecs": float(probe_us),
        "join-usecs": float(join_us),
        "results": int(results.group(1)) if results else None,
    }


def parse_sync(res: str) -> dict:
    """The tier and the phase times (usec) of --engine-sync-stats' table."""
    tier = re.search(r"\[SYNC\] tier=(\S+)", res)
    phases = {m.group(1): float(m.group(2)) for m in re.finditer(
        r"\[SYNC\]\s+phase (\w+)\s+([\d.]+) us", res)}
    return {"tier": tier.group(1) if tier else None, "phases": phases}


def expected_count(cfg: JoinConfig):
    """The count a configuration's generated workload must give, where it
    is fixed: |S| - floor(|S|(1 - q)) for the uniform PK/FK workload, |S|
    for a Zipf S over R's keys; None otherwise."""
    from hwbloomradixjoin_tpu_torch.data import generator as G

    if cfg.non_unique or cfg.full_range:
        return None
    if cfg.skew > 0:
        return cfg.s_size
    return G.expected_uniform_match_count(cfg.s_size, cfg.selectivity)


def run_one(cfg: JoinConfig, timeout: int = 1200,
            env: dict | None = None) -> dict:
    """One CLI run of cfg (with --engine-sync-stats): its configuration,
    parsed stdout, tier, phases, expected count, exactness and wall
    seconds.  Raises with the run's stderr if it fails."""
    cmd = [sys.executable, "-m", CLI_MODULE, *cfg.to_args(),
           "--engine-sync-stats"]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env={**os.environ, **(env or {})},
                          cwd=REPO)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-2000:]}")
    row = {**dataclasses.asdict(cfg), **parse_result(proc.stdout),
           **parse_sync(proc.stdout), "wall-secs": time.time() - t0}
    row["expected"] = expected_count(cfg)
    row["exact"] = None if row["expected"] is None \
        else row["results"] == row["expected"]
    row["device"] = device_label(cfg.backend)
    return row


def device_label(backend: str) -> str:
    """What a row records as its device: cpu for the cpu backend, else the
    card's name and power limit (utils/roofline.card_line)."""
    return "cpu" if backend == "cpu" else card_line()


def _cell(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, dict):
        return json.dumps(v, sort_keys=True).replace("|", "/")
    return "" if v is None else str(v)


def markdown(rows: list[dict], cols=None) -> str:
    """A markdown table of the rows' columns (default: every column seen,
    in order of appearance)."""
    if cols is None:
        cols = list(dict.fromkeys(k for r in rows for k in r))
    lines = ["| " + " | ".join(cols) + " |",
             "|" + "---|" * len(cols)]
    lines += ["| " + " | ".join(_cell(r.get(c)) for c in cols) + " |"
              for r in rows]
    return "\n".join(lines) + "\n"


def save_data(rows: list[dict], name: str, out_dir=None) -> list[dict]:
    """Write the rows to <out_dir>/<name>.jsonl, one JSON object a row,
    and <name>.md, a markdown table of every column seen."""
    out = Path(out_dir or OUT_DIR)
    out.mkdir(parents=True, exist_ok=True)
    with open(out / f"{name}.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    (out / f"{name}.md").write_text(markdown(rows))
    print(f"saved {len(rows)} rows -> {out / name}.jsonl/.md", flush=True)
    return rows


def load_rows(name: str, out_dir=None) -> list[dict]:
    """The rows an earlier run of a sweep saved, or []."""
    path = Path(out_dir or OUT_DIR) / f"{name}.jsonl"
    if not path.exists():
        return []
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln]


def same_config(row: dict, cfg: JoinConfig) -> bool:
    """True iff the row was run with every field of cfg."""
    return all(row.get(k) == v for k, v in dataclasses.asdict(cfg).items())


def run_sweep(name: str, jobs, out_dir=None, resume: bool = False,
              timeout: int = 7200) -> list[dict]:
    """Run each (JoinConfig, extra columns) of jobs, saving after every
    row.  With resume, the rows of an earlier run are kept and a job whose
    whole JoinConfig equals a kept row's is skipped, with a line saying
    so."""
    rows = load_rows(name, out_dir) if resume else []
    for cfg, extra in jobs:
        if resume and any(same_config(r, cfg) for r in rows):
            print(f"resume {name}: {cfg.cmdline()} is in {name}.jsonl",
                  flush=True)
            continue
        row = {**run_one(cfg, timeout=timeout), **extra}
        print(f"{name}: {cfg.cmdline()} -> Results={row['results']} "
              f"tier={row['tier']} {row['time-usecs']:.1f} us "
              f"exact={row['exact']}", flush=True)
        rows.append(row)
        save_data(rows, name, out_dir)
    return save_data(rows, name, out_dir)


def sweep_quick(backend="auto", out_dir=None):
    jobs = []
    for algo in ("NPO_st", "PRO"):
        for bloom in ("no", "blocked"):
            if algo.startswith("NPO") and bloom != "no":
                continue
            jobs.append((JoinConfig(
                algorithm=algo, r_size=100_000, s_size=400_000,
                selectivity=0.25, threads=4, bloom_filter=bloom,
                bloom_size=1 << 20, bloom_hashes=2, backend=backend), {}))
    return run_sweep("quick", jobs, out_dir)


def sweep_bloom(backend="auto", r_size=1_000_000, s_size=8_000_000, m=None,
                inner=4, ks=(1, 2, 4, 8), out_dir=None):
    """Basic vs blocked x k at q = 0.01, beside PRO without a filter (the
    reference's best_bloom_filter_type); m scales with |R|."""
    if m is None:
        m = 1 << min(max((r_size * 8 - 1).bit_length(), 20), 30)
    base = dict(algorithm="PRO", r_size=r_size, s_size=s_size,
                selectivity=0.01, no_dense=True, inner=inner, backend=backend)
    jobs = [(JoinConfig(**base), {"bloom": "no", "k": 0})]
    jobs += [(JoinConfig(**base, bloom_filter=variant, bloom_size=m,
                         bloom_hashes=k), {"bloom": variant, "k": k})
             for variant, k in itertools.product(("blocked", "basic"),
                                                  tuple(ks))]
    return run_sweep("bloom_filter_type", jobs, out_dir)


def sweep_params(backend="auto", inner=4, r_sizes=(250_000, 1_000_000),
                 out_dir=None):
    """|R| x S:R x q (the reference's test_parameters)."""
    jobs = [(JoinConfig(algorithm="PRO", r_size=r_size, no_dense=True,
                        s_size=r_size * ratio, selectivity=q, inner=inner,
                        backend=backend), {"ratio": ratio, "q": q})
            for r_size, ratio, q in itertools.product(
                r_sizes, (1, 4, 8), (0.001, 0.01, 0.1))]
    return run_sweep("test_parameters", jobs, out_dir)


def plan_bits(algo: str, r_size: int, bits) -> int:
    """The fan-out the planner gives a dense PK over [1, r_size]: the
    bitmap join's for PRO, the count tables' for PRHO (a request outside
    the window is clamped into it)."""
    from hwbloomradixjoin_tpu_torch.ops import bitmap_join, prho_join

    if algo in ("PRO", "RJ"):
        return bitmap_join.plan_geometry(1, r_size, bits)[0]
    return prho_join.plan_geometry_counts(1, r_size, bits)[0]


def sweep_radix_bits(backend="auto", r_size=WORKLOAD_B, s_size=WORKLOAD_B,
                     bits_list=None, inner=4, algos=("PRO", "PRHO"),
                     out_dir=None):
    """Figure 9's fan-out axis (12-17 bits, then the planner's own choice)
    for PRO and PRHO at workload B.  A width the planner clamps (PRO past
    15 bits at 2^27 keys, PRHO under 13) and a choice of the planner's
    already run are printed and not run, so no row stands under a width
    it did not plan.  Resumes rows of an equal configuration."""
    if bits_list is None:
        bits_list = [*range(12, 18), None]
    jobs, ran = [], set()
    for algo, bits in itertools.product(algos, bits_list):
        got = plan_bits(algo, r_size, bits)
        if (bits is not None and got != bits) or (algo, got) in ran:
            print(f"radix_bits: {algo} {bits if bits is not None else 'auto'}"
                  f" plans {got} bits: not run", flush=True)
            continue
        ran.add((algo, got))
        jobs.append((JoinConfig(algorithm=algo, r_size=r_size, s_size=s_size,
                                radix_bits=got, no_dense=True, inner=inner,
                                backend=backend),
                     {"radix-bits": -1 if bits is None else bits,
                      "plan-bits": got}))
    return run_sweep("radix_bits", jobs, out_dir, resume=True)


def sweep_never_single_pass(backend="auto", r_size=1_000_000,
                            s_size=8_000_000, out_dir=None):
    """Least vs most fan-out x filter variant x k (the reference's
    never_single_pass)."""
    range_bits = max((r_size - 1).bit_length(), 12)
    fanouts = [max(range_bits - 17, 0), max(range_bits - 12, 0)]
    jobs = [(JoinConfig(algorithm="PRO", r_size=r_size, s_size=s_size,
                        selectivity=0.01, radix_bits=bits, no_dense=True,
                        bloom_filter=variant, bloom_size=1 << 26,
                        bloom_hashes=k, inner=4, backend=backend),
             {"radix-bits": bits})
            for bits, variant, k in itertools.product(
                fanouts, ("no", "basic", "blocked"), (1, 3))
            if variant != "no" or k == 1]
    return run_sweep("never_single_pass", jobs, out_dir)


def sweep_passes(backend="auto", r_size=1_000_000, s_size=8_000_000,
                 out_dir=None):
    """One vs two partition passes at a forced fan-out."""
    bits = max(max((r_size - 1).bit_length(), 12) - 14, 2)
    jobs = [(JoinConfig(algorithm="PRO", r_size=r_size, s_size=s_size,
                        radix_bits=bits, no_dense=True, passes=passes,
                        inner=4, backend=backend), {"passes": passes})
            for passes in (1, 2)]
    return run_sweep("passes", jobs, out_dir)


def sweep_algos(backend="auto", r_size=1_000_000, s_size=8_000_000, inner=4,
                name="algos", out_dir=None):
    """Figure 11's PRO vs PRH vs PRHO vs NPO on one workload.  Resumes
    rows of an equal configuration."""
    jobs = [(JoinConfig(algorithm=algo, r_size=r_size, s_size=s_size,
                        no_dense=True, backend=backend, inner=inner),
             {"algo": algo}) for algo in ("PRO", "PRH", "PRHO", "NPO")]
    return run_sweep(name, jobs, out_dir, resume=True)


def sweep_algos_b(backend="auto", inner=2, out_dir=None):
    """sweep_algos at workload B, 128M x 128M (the reference's figure 11:
    9.85 / 12.73 / 11.35 ns a tuple for PRO / PRH / PRHO, isengard)."""
    return sweep_algos(backend=backend, r_size=WORKLOAD_B, s_size=WORKLOAD_B,
                       inner=inner, name="algos_B", out_dir=out_dir)


def group_by_zipf(cfg: JoinConfig, device) -> dict:
    """group_by_key over the Zipf S of cfg's workload, with S's payloads
    as values, in this process: its groups (the host's distinct keys), the
    hottest key's share of S and its time (utils/timing.time_usec: CUDA
    events on the card, one host-clock call on the CPU).  Raises unless
    the counts total |S| and the groups are the host's."""
    import numpy as np
    import torch

    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.ops import aggregate
    from hwbloomradixjoin_tpu_torch.utils.timing import time_usec

    _, _, sk, sp = G.build_workload(G.WorkloadParams(
        r_size=cfg.r_size, s_size=cfg.s_size, r_seed=cfg.r_seed,
        s_seed=cfg.s_seed, nthreads=cfg.threads, skew=cfg.skew))
    hist = np.bincount(sk)
    keys = torch.from_numpy(sk).to(device)
    vals = torch.from_numpy(sp).to(device)
    _, counts, _, groups = aggregate.group_by_key(keys, vals)
    want = int(np.count_nonzero(hist))
    if int(groups) != want or int(counts.long().sum()) != cfg.s_size:
        raise AssertionError(f"group_by_key z={cfg.skew}: {int(groups)} "
                             f"groups (host {want})")
    del counts
    ms = time_usec(lambda: aggregate.group_by_key(keys, vals), device) / 1e3
    return {"groups": want, "hot-share": float(hist.max() / len(sk)),
            "group-by-ms": ms}


def sweep_zipf(backend="auto", r_size=16_000_000, s_size=128_000_000,
               inner=4, out_dir=None):
    """PRO over a Zipf S over R's keys at each z (the reference's -z),
    every S key in R, beside group_by_key over the same S."""
    from hwbloomradixjoin_tpu_torch.cli import device_of

    device = device_of(backend)
    rows = []
    for z in ZIPF_ZS:
        cfg = JoinConfig(algorithm="PRO", r_size=r_size, s_size=s_size,
                         skew=z, no_dense=True, inner=inner, backend=backend)
        rows.append({**run_one(cfg, timeout=7200),
                     **group_by_zipf(cfg, device)})
        print(f"zipf z={z}: Results={rows[-1]['results']} "
              f"{rows[-1]['time-usecs']:.1f} us, group_by_key "
              f"{rows[-1]['group-by-ms']:.4f} ms", flush=True)
        save_data(rows, "zipf", out_dir)
    return save_data(rows, "zipf", out_dir)


def _world_rows(name: str, nproc: int, cases: list, extra: list, backend,
                out_dir=None) -> list[dict]:
    """Run the distributed cases on nproc gloo ranks, on the CPU for the
    cpu backend and else sharing the card, and hold each against
    native.ref_join and the host filter: one row a case, its time on the
    host's clock."""
    from hwbloomradixjoin_tpu_torch.cli import device_of
    from hwbloomradixjoin_tpu_torch.parallel import multiproc

    device = device_of(backend).type
    rec = multiproc.run_world(nproc, cases, device=device, backend="gloo",
                              timeout=7200)
    rows = []
    for c, r, more in zip(cases, rec["results"], extra):
        cnt, sr, ss, after = multiproc.expected(c)
        want = [cnt, 0, 0, after, 0] if c["kw"].get("local_engine") \
            == "pallas" else [cnt, sr, ss, after, 0]
        rows.append({"case": c["name"], "devices": r["n_dev"],
                     **c["workload"], **c["kw"], "outputs": r["outputs"],
                     "expected": want, "exact": r["outputs"] == want,
                     "host-seconds": r["seconds"], "ranks-on": device,
                     "device": device_label(backend), **more})
    return save_data(rows, name, out_dir)


def sweep_scaling(backend="auto", r_size=500_000, s_size=4_000_000,
                  max_devices=8, out_dir=None):
    """The distributed join on 1, 2, 4, ... max_devices gloo ranks of one
    world, each local engine, at q = 0.25: speedup and efficiency T(1) /
    (N T(N)) by the host clock, best of 3 runs.  All ranks share one
    machine's cores (and, off the cpu backend, one card), so these measure
    the join's distribution overhead, not hardware scaling."""
    from hwbloomradixjoin_tpu_torch.parallel import multiproc

    ns = [1 << i for i in range(max_devices.bit_length())]
    workload = {"r_size": r_size, "s_size": s_size, "nthreads": 8,
                "selectivity": 0.25}
    cases, extra = [], []
    for engine, n in itertools.product(("pallas", "sortscan"), ns):
        kw = {"local_engine": engine}
        if engine == "pallas":
            kw["key_range"] = [1, r_size]
        cases.append(multiproc.case(f"{engine}[{n}]", n, workload,
                                    repeats=3, **kw))
        extra.append({"local-join": engine})
    rows = _world_rows("scaling", max(ns), cases, extra, backend, out_dir)
    for r in rows:
        base = next(b for b in rows if b["local-join"] == r["local-join"]
                    and b["devices"] == 1)["host-seconds"]
        r["speedup-vs-1dev"] = base / r["host-seconds"]
        r["scaling-efficiency"] = base / (r["devices"] * r["host-seconds"])
    return save_data(rows, "scaling", out_dir)


def sweep_dist_bloom(backend="auto", r_size=1_000_000, s_size=8_000_000,
                     devices=8, out_dir=None):
    """The distributed join through each filter on `devices` gloo ranks, at
    q = 0.01: S-tuples after the filter and the S bytes the shuffle then
    exchanges (8 a tuple), against the unfiltered join."""
    from hwbloomradixjoin_tpu_torch.parallel import multiproc

    workload = {"r_size": r_size, "s_size": s_size, "nthreads": 8,
                "selectivity": 0.01}
    cases, extra = [], []
    for variant, k in (("no", 0), ("blocked", 1), ("blocked", 4),
                       ("basic", 1)):
        kw = {} if variant == "no" else {"bloom": {
            "variant": variant, "m": 1 << 26, "k": k, "B": 512}}
        cases.append(multiproc.case(f"{variant}-k{k}", devices, workload,
                                    repeats=3, **kw))
        extra.append({"bloom": variant, "k": k, "m": 1 << 26})
    rows = _world_rows("dist_bloom", devices, cases, extra, backend,
                       out_dir)
    for r in rows:
        surv = s_size if r["outputs"][3] < 0 else r["outputs"][3]
        r["s-exchanged-bytes"] = surv * 8
        r["exchange-reduction"] = s_size / max(surv, 1)
    return save_data(rows, "dist_bloom", out_dir)


SWEEPS = {"quick": sweep_quick, "bloom": sweep_bloom, "params": sweep_params,
          "radix_bits": sweep_radix_bits,
          "never_single_pass": sweep_never_single_pass,
          "passes": sweep_passes, "algos": sweep_algos,
          "algos_b": sweep_algos_b, "zipf": sweep_zipf,
          "scaling": sweep_scaling, "dist_bloom": sweep_dist_bloom}


def _env_kwargs() -> dict:
    """The sizes the environment overrides (the JAX harness's names)."""
    kw = {}
    for k, env in (("r_size", "HBRJ_SWEEP_R"), ("s_size", "HBRJ_SWEEP_S"),
                   ("inner", "HBRJ_SWEEP_INNER"), ("m", "HBRJ_SWEEP_M")):
        if os.environ.get(env) is not None:
            kw[k] = int(os.environ[env])
    for k, env, conv in (("ks", "HBRJ_SWEEP_KS", int),
                         ("r_sizes", "HBRJ_SWEEP_RSIZES", int),
                         ("bits_list", "HBRJ_SWEEP_BITS", int)):
        if os.environ.get(env):
            kw[k] = tuple(conv(x) for x in os.environ[env].split(","))
    return kw


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("sweep", choices=sorted(SWEEPS))
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"],
                   help="the backend of every run (cpu: the plain twins; "
                        "scaling and dist_bloom: ranks on the CPU, else "
                        "sharing the card)")
    p.add_argument("--out", default=None,
                   help=f"output directory (default {OUT_DIR})")
    a = p.parse_args(argv)
    from hwbloomradixjoin_tpu_torch.cli import device_of

    device_of(a.engine_backend)         # raises without a card
    fn = SWEEPS[a.sweep]
    params = inspect.signature(fn).parameters
    kw = {k: v for k, v in _env_kwargs().items() if k in params}
    rows = fn(backend=a.engine_backend, out_dir=a.out, **kw)
    bad = [r for r in rows if r.get("exact") is False]
    for r in bad:
        print(f"INEXACT: {r}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
