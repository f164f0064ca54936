"""One run of one benchmark cell of the PyTorch and CUDA port, on the card.

    python -m joinbench.run --workload brj_flagship.bloom --seed 7 \
        --seconds 40 --trace 0

Reads the cell from ``BENCHMARK.json``, its configuration from the file
the configuration names and its traffic from ``joinbench/traffic/``, then:

1. set-up (``setup_s``, from this module's first line to the first timed
   query): imports torch and the port, makes the relations on the card from
   ``--seed`` (``joinbench.datagen``), warms the cell's own query up;
2. the window: one client in a closed loop for ``--seconds``; each query is
   what a caller of the library issues, ``registry.plan_join`` and then the
   plan's whole join with its result read to the host;
3. the check: the reference (``joinbench.reference``) works every answer
   out again from the same relations, once the window has closed, and every
   query's answers are compared with it;
4. with ``--trace 1``, the per-layer metrics instead of the end-to-end
   ones: host spans around the plan, CUDA-event means of the plan's phases,
   and a profiled stretch of whole queries in the window;
5. one JSON line, the last on standard output; the numbers compared, each
   with its limit, are the last lines on standard error.

Without a card, or with fewer cards than the cell asks for, it exits
non-zero and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".joinbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "hwbloomradixjoin_tpu")
WARM_MAX = 6               # warm-up queries at most
WARM_STEADY = 0.10         # warm once two queries' times agree this closely
STRETCH_S = 1.0            # profiled stretch: at least this long,
STRETCH_MIN = 3            # at least this many queries,
STRETCH_MAX = 50           # and at most this many


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(workload: str, root: Path = ROOT):
    """(cell, configuration, traffic, per-layer metric entries) of a cell
    named in ``BENCHMARK.json``."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"joinbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    per_layer = [m for m in spec["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return cell, config, traffic, per_layer


def metric_reader(name: str):
    """The ``read`` function of ``joinbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"joinbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


class Query:
    """The cell's query through the port's public entry point."""

    def __init__(self, rel, config: dict, traffic: dict, plan_join=None):
        from hwbloomradixjoin_tpu_torch.config import (BloomArgs,
                                                       BloomVariant,
                                                       EngineConfig)
        from hwbloomradixjoin_tpu_torch.models import registry
        from hwbloomradixjoin_tpu_torch.types import KeyStats, Relation

        self.traffic = traffic
        self.plan_join = plan_join or registry.plan_join
        # R as the generator declares it: a primary key over [1, r_size]
        self.R = Relation(key=rel.r_key, payload=rel.r_pay, stats=KeyStats(
            min_key=1, max_key=config["r_size"], is_dense_pk=True,
            is_unique=True))
        self.S = Relation(key=rel.s_key, payload=rel.s_pay)
        self.cfg = EngineConfig(allow_dense=traffic["allow_dense"])
        self.bloom = None
        if traffic["filter"]:
            f = config["filter"]
            self.bloom = BloomArgs(variant=BloomVariant(f["variant"]),
                                   m=f["m"], k=f["k"], B=f["B"],
                                   seed=f["seed"])

    def plan(self):
        plan, tier = self.plan_join(self.traffic["algorithm"], self.R,
                                    self.S, self.cfg, self.bloom)
        if tier != self.traffic["tier"]:
            raise RuntimeError(f"the planner took tier {tier}, not the "
                               f"cell's {self.traffic['tier']}")
        return plan

    def __call__(self, span) -> tuple[dict, float]:
        """One query: (its answers, the seconds plan_join took)."""
        with span("query"):
            t0 = time.perf_counter()
            with span("plan"):
                plan = self.plan()
            t_plan = time.perf_counter() - t0
            with span("full"):
                out = plan.full()
            with span("readback"):
                if self.traffic["result"] == "count":
                    answers = {"count": int(out)}
                else:
                    count, r_sum, s_sum = out.tolist()
                    answers = {"count": count, "r_sum": r_sum,
                               "s_sum": s_sum}
                if self.traffic["filter"]:
                    answers["s_after"] = int(plan.s_after)
        return answers, t_plan


def no_span(_name):
    return nullcontext()


class Profiled:
    """Spans and a profiler over a steady stretch of the traced window."""

    def __init__(self, device):
        import torch

        self.torch, self.device = torch, device
        self.prof, self.started, self.queries, self.done = None, 0.0, 0, \
            False

    def span(self, name):
        return self.torch.profiler.record_function(name)

    def before(self, elapsed: float, seconds: float) -> None:
        if self.prof is None and not self.done and elapsed >= seconds / 3:
            acts = [self.torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(self.torch.profiler.ProfilerActivity.CUDA)
            self.prof = self.torch.profiler.profile(activities=acts,
                                                   acc_events=True)
            self.prof.start()
            self.started = time.perf_counter()

    def after(self) -> None:
        if self.prof is None or self.done:
            return
        self.queries += 1
        long_enough = time.perf_counter() - self.started >= STRETCH_S
        if (self.queries >= STRETCH_MIN and long_enough) \
                or self.queries >= STRETCH_MAX:
            self.prof.stop()
            self.done = True


def window(query, seconds: float, profiled=None):
    """The closed loop: queries back to back until `seconds` have passed
    (and, when traced, the profiled stretch is complete).  Returns
    (answers, latencies, plan seconds, window seconds)."""
    span = no_span if profiled is None else profiled.span
    results, latencies, plan_s = [], [], []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if t0 - start >= seconds and results and \
                (profiled is None or profiled.done):
            break
        if profiled is not None:
            profiled.before(t0 - start, seconds)
        answers, t_plan = query(span)
        end = time.perf_counter()
        if profiled is not None:
            profiled.after()
        results.append(answers)
        latencies.append(end - t0)
        plan_s.append(t_plan)
    return results, latencies, plan_s, end - start


def warm_up(query) -> int:
    """Queries until two in a row take times within WARM_STEADY."""
    prev = None
    for n in range(1, WARM_MAX + 1):
        t0 = time.perf_counter()
        query(no_span)
        t = time.perf_counter() - t0
        if prev is not None and abs(t - prev) <= WARM_STEADY * prev:
            break
        prev = t
    return n


def card_limit() -> str | None:
    """nvidia-smi's name and power limit of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def p95(values) -> float:
    return statistics.quantiles(values, n=100, method="inclusive")[94] \
        if len(values) > 1 else values[0]


def execute(cell: dict, config: dict, traffic: dict, per_layer: list,
            seed: int, seconds: float, trace: bool, device,
            plan_join=None) -> dict:
    """Set-up, window, check and readings of one run; the result object."""
    import torch

    from joinbench import datagen, reference
    from joinbench import trace as tr

    device = torch.device(device)
    t = time.perf_counter()
    rel = datagen.make(config, seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()        # the generator's temporaries
    log(f"joinbench: imports {t - T0:.3f} s, relations "
        f"{time.perf_counter() - t:.3f} s")
    query = Query(rel, config, traffic, plan_join)
    t = time.perf_counter()
    n_warm = warm_up(query)
    log(f"joinbench: warm-up {n_warm} queries, "
        f"{time.perf_counter() - t:.3f} s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    profiled = Profiled(device) if trace else None
    setup_s = time.perf_counter() - T0
    results, latencies, plan_s, window_s = window(query, seconds, profiled)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else None
    card = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    log(f"joinbench: {len(results)} queries in {window_s:.3f} s, "
        f"peak {peak} bytes")

    metrics, extra = {}, {}
    if trace:
        plan = query.plan()
        phases = tr.phase_ms(plan, device)
        del plan
        log("joinbench: phases (ms) " + json.dumps(phases))
        st = tr.reduce(*tr.profiled_events(profiled.prof, device))
        extra = {"busy_s": st.busy_s, "window_s": st.window_s}
        log(f"joinbench: profiled {st.queries} queries, "
            f"{st.window_s:.6f} s, busy {st.busy_s:.6f} s")
        readings = tr.Readings(config=config, traffic=traffic, card=card,
                               plan_s=plan_s, phase_ms=phases, stretch=st)
        for m in per_layer:
            value = metric_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        s_tuples = len(results) * config["s_size"]
        metrics = {
            "s_tuples_per_s": {"value": s_tuples / window_s,
                               "unit": "tuples/s"},
            "join_ms_p95": {"value": 1e3 * p95(latencies), "unit": "ms"}}
        if peak is not None:
            metrics["device_bytes_per_input_byte"] = {
                "value": peak / rel.column_bytes(), "unit": "B/B"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    del query
    t = time.perf_counter()
    want = reference.answers(rel, config, traffic)
    widest, failed = reference.compare(results, want)
    log(f"joinbench: reference {time.perf_counter() - t:.3f} s: "
        + json.dumps(want))

    out = {"correct": failed == 0 and len(results) > 0,
           "attempted": len(results), "failed": failed, "metrics": metrics,
           "device": {"platform": "gpu" if device.type == "cuda" else "cpu",
                      "kind": card, "count": 1,
                      "memory_peak_bytes": peak or 0, **extra,
                      "card": card_limit() if device.type == "cuda"
                      else None}}
    if trace:
        out["breakdown"] = tr.breakdown(st)
    out["checks"] = {f"{name}_gap": {"value": widest[name],
                                     "limit": reference.LIMITS[name]}
                     for name in want}
    return out


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def emit(out: dict) -> None:
    for name, check in out["checks"].items():
        log(f"check {name}: {check['value']} (limit {check['limit']})")
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    cell, config, traffic, per_layer = resolve(args.workload)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        log(f"joinbench: the cell needs {cell['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count()}: no result")
        return 2
    import hwbloomradixjoin_tpu_torch  # noqa: F401  (fails without the port)

    out = execute(cell, config, traffic, per_layer, args.seed, args.seconds,
                  bool(args.trace), "cuda")
    found = foreign_modules()
    if found:
        log("joinbench: JAX modules loaded: " + ", ".join(found))
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
