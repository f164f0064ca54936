"""mchashjoins-compatible command-line driver for the port.

Counterpart of ``hwbloomradixjoin_tpu/cli.py``: the same flags and the same
stdout lines as the reference binary (src/main.c parse_args:557-731 and its
[INFO ]/timing lines), so that ``measurements/run.py``'s parse_result reads
either engine:

    python -m hwbloomradixjoin_tpu_torch.cli -a PRO -r 16000000 \\
        -s 128000000 -n 8 -q 0.01 -b blocked -m 134217728 -k 1 -B 512

Joins run on the card; ``--engine-backend cpu`` runs them on the CPU (the
kernels' plain twins), and without a card any other backend raises.  Engine
flags that the reference lacks are prefixed --engine-*.
"""

from __future__ import annotations

import argparse
import contextlib
import sys

import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mchashjoins-cuda", add_help=False,
        description="hash join engine on the GPU (mchashjoins-compatible "
                    "CLI)")
    p.add_argument("-a", "--algo", default="PRO",
                   choices=["RJ", "PRO", "PRH", "PRHO", "NPO", "NPO_st"])
    p.add_argument("-n", "--nthreads", type=int, default=2,
                   help="generator thread-layout parameter (kept for "
                        "multiset parity)")
    p.add_argument("-r", "--r-size", type=int, default=128_000_000)
    p.add_argument("-s", "--s-size", type=int, default=128_000_000)
    p.add_argument("-x", "--r-seed", type=int, default=12345)
    p.add_argument("-y", "--s-seed", type=int, default=54321)
    p.add_argument("-q", "--s-sel", type=float, default=1.0)
    p.add_argument("-z", "--skew", type=float, default=0.0)
    p.add_argument("-R", "--r-file", default=None)
    p.add_argument("-S", "--s-file", default=None)
    p.add_argument("--non-unique", action="store_true")
    p.add_argument("--full-range", action="store_true")
    p.add_argument("--basic-numa", action="store_true",
                   help="accepted for CLI parity; one card has one memory")
    p.add_argument("-b", "--bloom-filter", default="no",
                   choices=["no", "basic", "blocked"])
    p.add_argument("-m", "--bloom-size", type=int, default=256 << 20)
    p.add_argument("-k", "--bloom-hashes", type=int, default=8)
    p.add_argument("-B", "--bloom-block-size", type=int, default=1024)
    p.add_argument("-p", "--perfconf", default=None)
    p.add_argument("-o", "--perfout", default=None)
    p.add_argument("-h", "--help", action="help")
    p.add_argument("-v", "--version", action="store_true")
    p.add_argument("--verbose", action="store_true",
                   help="print each phase of the bitmap radix join against "
                   "its bound")
    # engine extras
    p.add_argument("--engine-backend", default="auto",
                   choices=["auto", "cuda", "cpu"],
                   help="auto and cuda: the card (raises without one); cpu: "
                        "the plain twins, for validation runs")
    p.add_argument("--engine-radix-bits", type=int, default=None)
    p.add_argument("--engine-passes", type=int, default=1, choices=[1, 2],
                   help="radix partition passes (reference NUM_PASSES)")
    p.add_argument("--engine-no-pallas", action="store_true",
                   help="the portable tiers only (RadixConfig("
                        "use_kernels=False); the name the harness knows)")
    p.add_argument("--engine-inner", type=int, default=1,
                   help="back-to-back joins a timing (total = the best "
                        "repeat's mean)")
    p.add_argument("--engine-repeats", type=int, default=1,
                   help="re-run the join N times, report the best")
    p.add_argument("--key8b", action="store_true",
                   help="16B tuples / int64 keys (reference --enable-key8B)")
    p.add_argument("--materialize", action="store_true",
                   help="materialize rid pairs (JOIN_RESULT_MATERIALIZE)")
    p.add_argument("--out-file", default=None,
                   help="write materialized result to this .tbl (Out.tbl)")
    p.add_argument("--engine-sync-stats", action="store_true",
                   help="per-phase time table (SYNCSTATS analog)")
    p.add_argument("--engine-no-dense", action="store_true",
                   help="disable the dense-PK planner fast path")
    p.add_argument("--engine-trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the joins "
                        "into DIR")
    p.add_argument("--engine-local-join", choices=("sortscan", "pallas"),
                   default="sortscan",
                   help="each device's join in distributed mode: sortscan "
                        "(carries checksums) or pallas (the bitmap kernels, "
                        "count only)")
    p.add_argument("--engine-devices", type=int, default=0,
                   help="run the distributed join over N devices, one "
                        "process each (a launcher's HBRJ_* environment, or "
                        "N = 1 on this process); 0 = the local engine")
    return p


def device_of(backend: str) -> torch.device:
    """The device a backend name runs on: the CPU for "cpu", else the card,
    which must exist."""
    if backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--engine-backend {backend}: no CUDA device "
                           "(pass --engine-backend cpu for the CPU)")
    return torch.device("cuda")


def roofline_lines(stats, R, S, filtered: bool, dev) -> str:
    """--verbose's roofline: each phase of the bitmap radix join against
    its bound on this card.  The join's S keys in R's range, which the
    survivor compaction keeps, are counted after the timed run."""
    from hwbloomradixjoin_tpu_torch.utils import roofline

    chip = roofline.chip_model() if dev.type == "cuda" else None
    if chip is None:
        return roofline.report({}, {}, None)
    if filtered or stats.tier not in roofline.MODELLED_TIERS:
        return (f"roofline: no model of tier {stats.tier}"
                f"{' with a filter' if filtered else ''}; no bound printed")
    ph = stats.phases
    lo, hi = int(R.key.min()), int(R.key.max())
    s_live = None
    if "compact" in ph:
        s_live = int(((S.key >= lo) & (S.key <= hi)).sum())
    costs = roofline.join_costs(
        R.key.numel(), S.key.numel(), hi - lo + 1,
        passes=2 if "s_pass2" in ph else 1, s_live=s_live)
    measured = {
        "partition_R": ph["r_partition"] / 1e6,
        "build": ph["build"] / 1e6,
        "partition_S": sum(ph.get(k, 0.0) for k in
                           ("compact", "s_partition", "s_pass2")) / 1e6,
        "probe": ph["probe"] / 1e6}
    return roofline.report(measured, costs, chip)


def _run_local(args, params, rk, rp, sk, sp, cfg, bloom_args, dev):
    """One card's join through run_join, the best of --engine-repeats:
    (JoinResult, JoinStats, R, S)."""
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.models import run_join
    from hwbloomradixjoin_tpu_torch.types import Relation
    from hwbloomradixjoin_tpu_torch.utils import profiling

    r_stats = None if (args.r_file or args.s_file) else G.r_key_stats(params)
    R = Relation.from_numpy(rk, rp, device=dev, stats=r_stats,
                            key8b=args.key8b)
    S = Relation.from_numpy(sk, sp, device=dev, key8b=args.key8b)
    best = None
    with profiling.trace(args.engine_trace) if args.engine_trace \
            else contextlib.nullcontext():
        for _ in range(max(1, args.engine_repeats)):
            with profiling.span("hbrj.run_join"):
                result, stats, _ = run_join(
                    args.algo, R, S, cfg, bloom_args,
                    inner_repeats=max(1, args.engine_inner))
            if best is None or stats.total_usec < best[1].total_usec:
                best = (result, stats)
    if args.engine_trace:
        print(f"[INFO ] Profiler trace written to {args.engine_trace}")
    return (*best, R, S)


def _run_distributed(args, rk, rp, sk, sp, bloom_args, dev):
    """The distributed join (parallel/dist_join.py) over
    --engine-devices ranks, timed: (JoinResult, JoinStats), or None on a
    rank outside the mesh.

    Joins the launcher's world (HBRJ_* environment) or, for one device,
    starts a world of one on this process; a world this call started, it
    ends.  The shards are placed once, outside the timing; one warm run,
    then the best of --engine-repeats runs by the host clock, each read
    back.  The tier names the device count and the local engine, e.g.
    dist[1]/pallas.  The pallas engine's kernels count runs of any length
    exactly, so its count stands whatever the JAX package's window flag
    says: there is no fallback to sortscan.
    """
    import time

    import torch.distributed as dist

    from hwbloomradixjoin_tpu_torch.parallel import dist_join, mesh
    from hwbloomradixjoin_tpu_torch.types import JoinResult
    from hwbloomradixjoin_tpu_torch.utils.timing import JoinStats

    if args.key8b or args.materialize:
        raise ValueError("--engine-devices: the distributed join counts "
                         "8-byte tuples (no --key8b, no --materialize)")
    started = not dist.is_initialized()
    try:
        if started:
            mesh.init_distributed(dev)
        group = mesh.make_mesh(args.engine_devices, dev)
        if not mesh.in_mesh(group):
            return None
        plan = dist_join.plan_dist_join(group, rk, rp, sk, sp, bloom_args,
                                        local_engine=args.engine_local_join,
                                        device=dev)
        plan.run()
        total = None
        for _ in range(max(1, args.engine_repeats)):
            t0 = time.perf_counter()
            cnt, _, _, s_after, ovf = plan.run()
            cnt = int(cnt)
            dt = (time.perf_counter() - t0) * 1e6
            total = dt if total is None else min(total, dt)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    if int(ovf):
        print(f"[WARN ] shuffle capacity overflow: {int(ovf)} tuples")
    after = None if bloom_args is None else int(s_after)
    stats = JoinStats(total_usec=total, probe_usec=total, result=cnt,
                      num_s_tuples=len(sk), s_after_filter=after,
                      tier=f"dist[{args.engine_devices}]/"
                           f"{args.engine_local_join}")
    return JoinResult(total_results=cnt, s_after_filter=after), stats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.version:
        import hwbloomradixjoin_tpu_torch as hb
        print(f"\nhwbloomradixjoin_tpu_torch {hb.__version__}")
        print("PyTorch + CUDA port of the mchashjoins/HwBloomRadixJoin "
              "suite.\n")
        return 0
    dev = device_of(args.engine_backend)

    from hwbloomradixjoin_tpu_torch.config import (BloomArgs, BloomVariant,
                                                   EngineConfig, RadixConfig)
    from hwbloomradixjoin_tpu_torch.data import generator as G
    from hwbloomradixjoin_tpu_torch.data import tblio
    from hwbloomradixjoin_tpu_torch.utils.timing import (print_sync_stats,
                                                         print_timing)

    tuple_bytes = 16 if args.key8b else 8

    def info_create(name, size, loading):
        mib = tuple_bytes * size / 1024.0 / 1024.0
        sys.stdout.write(
            f"[INFO ] {'Loading' if loading else 'Creating'} relation {name} "
            f"with size = {mib:.3f} MiB, #tuples = {size} : ")
        sys.stdout.flush()

    params = G.WorkloadParams(
        r_size=args.r_size, s_size=args.s_size, r_seed=args.r_seed,
        s_seed=args.s_seed, nthreads=args.nthreads, skew=args.skew,
        selectivity=args.s_sel, nonunique_keys=args.non_unique,
        fullrange_keys=args.full_range, key8b=args.key8b)

    info_create("R", args.r_size, args.r_file is not None)
    if args.r_file or args.s_file:
        print("OK ")
        info_create("S", args.s_size, args.s_file is not None)
        rk, rp = tblio.read_relation(args.r_file, args.r_size)
        sk, sp = tblio.read_relation(args.s_file, args.s_size)
        print("OK ")
    else:
        rk, rp, sk, sp = G.build_workload(params)
        print("OK ")
        info_create("S", args.s_size, False)
        print("OK ")

    print(f"[INFO ] Running join algorithm {args.algo} ...")

    bloom_args = None
    if args.bloom_filter != "no":
        bloom_args = BloomArgs(
            variant=BloomVariant(args.bloom_filter), m=args.bloom_size,
            k=args.bloom_hashes, B=args.bloom_block_size)
    radix = RadixConfig(num_radix_bits=args.engine_radix_bits,
                        passes=args.engine_passes,
                        use_kernels=not args.engine_no_pallas)
    cfg = EngineConfig(radix=radix, materialize=args.materialize,
                       sync_stats=args.engine_sync_stats,
                       allow_dense=not args.engine_no_dense)
    if args.engine_devices >= 1:
        out = _run_distributed(args, rk, rp, sk, sp, bloom_args, dev)
        if out is None:
            print(f"[INFO ] This rank holds no device of the "
                  f"{args.engine_devices}-device mesh.")
            return 0
        result, stats = out
        if cfg.sync_stats:
            print_sync_stats(stats, stats.phases)
        R = S = None
    else:
        result, stats, R, S = _run_local(args, params, rk, rp, sk, sp, cfg,
                                         bloom_args, dev)

    print_timing(stats)
    if args.materialize and args.out_file:
        # write_result_relation equivalent (main.c:482-485, tuple_buffer.h)
        n = result.count()
        tblio.write_relation(args.out_file,
                             result.r_payload[:n].cpu().numpy(),
                             result.s_payload[:n].cpu().numpy())
        print(f"[INFO ] Materialized result written to {args.out_file}")
    if args.verbose and R is not None:
        print(roofline_lines(stats, R, S, bloom_args is not None, dev))
    print(f"[INFO ] Results = {result.count()}. DONE.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
