"""PyTorch port: the reference's command line (cli, confrun, unittests), the
.tbl files and the Zipf generator against the JAX package.

The CLI runs in-process on the CPU (``--engine-backend cpu``, the kernels'
plain twins) at small sizes; its stdout must parse with the measurement
harness's parse_result and carry the reference-validated counts.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu import confrun as jconfrun
from hwbloomradixjoin_tpu import unittests as junittests
from hwbloomradixjoin_tpu.data import native as jnative
from hwbloomradixjoin_tpu.data import tblio as jtblio
from hwbloomradixjoin_tpu_torch import cli, confrun, unittests
from hwbloomradixjoin_tpu_torch.config import BloomArgs, EngineConfig
from hwbloomradixjoin_tpu_torch.data import generator as G
from hwbloomradixjoin_tpu_torch.data import native, tblio
from hwbloomradixjoin_tpu_torch.models import run_join
from hwbloomradixjoin_tpu_torch.types import Relation
from hwbloomradixjoin_tpu_torch.utils import roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "measurements"))
from measurements.run import parse_result  # noqa: E402
from port_cpu import lean_cpu  # noqa: E402,F401  (autouse)

# tests/test_harness.py:12-21's two texts
CONF_TEXTS = [
    json.dumps({"algorithm": "NPO", "threads": 4}),
    'algorithm = "PRO";\nbuild.size = 1000; // c\nprobe.selectivity = 0.5;\n'
    'engine.use_pallas = false;\n',
]


@pytest.mark.parametrize("z", [0.75, 1.0])
def test_gen_zipf_matches_jax(z):
    """The port's binding of hbrj_gen_zipf emits the JAX package's keys."""
    got = native.gen_zipf(54321, 20_000, 3000, z)
    np.testing.assert_array_equal(got, jnative.gen_zipf(54321, 20_000, 3000,
                                                        z))
    assert got.min() >= 1 and got.max() <= 3000


def test_tblio_round_trips_against_jax(tmp_path):
    """write_relation writes the JAX package's bytes; read_relation reads
    them back, and pipe-separated and key-only rows."""
    rng = np.random.default_rng(4)
    k = rng.integers(-2**31, 2**31, 500).astype(np.int32)
    p = rng.integers(-2**31, 2**31, 500).astype(np.int32)
    tblio.write_relation(tmp_path / "port.tbl", k, p)
    jtblio.write_relation(tmp_path / "jax.tbl", k, p)
    assert (tmp_path / "port.tbl").read_bytes() == \
        (tmp_path / "jax.tbl").read_bytes()
    for got, want in zip(tblio.read_relation(tmp_path / "jax.tbl", 300),
                         (k[:300], p[:300])):
        np.testing.assert_array_equal(got, want)
    (tmp_path / "pipe.tbl").write_text("3|4\n5|6\n")
    (tmp_path / "keys.tbl").write_text("#KEY\n7\n8\n")
    for name in ("pipe.tbl", "keys.tbl"):
        for got, want in zip(tblio.read_relation(tmp_path / name),
                             jtblio.read_relation(tmp_path / name)):
            np.testing.assert_array_equal(got, want)


SMALL = ["-r", "3000", "-s", "20000", "-n", "4", "--engine-backend", "cpu"]


@pytest.mark.parametrize("name,argv,want", [
    # tests/test_harness.py:65's arguments and reference-validated count
    ("npo_st", ["-a", "NPO_st", "-r", "12345", "-s", "54321", "-n", "7",
                "-q", "0.999", "--engine-backend", "cpu",
                "--engine-no-pallas"], 54267),
    ("pro", ["-a", "PRO", "-q", "0.5", *SMALL],
     G.expected_uniform_match_count(20000, 0.5)),
    ("bpro", ["-a", "PRO", "-q", "0.01", "-b", "blocked", "-m", "65536",
              "-k", "1", "-B", "512", "--engine-no-dense", *SMALL],
     G.expected_uniform_match_count(20000, 0.01)),
    ("key8b", ["-a", "PRO", "--key8b", *SMALL], 20000),
    ("zipf", ["-a", "PRO", "-z", "1.0", *SMALL], 20000),
    ("prho", ["-a", "PRHO", "--engine-sync-stats", *SMALL], 20000),
])
def test_cli_prints_reference_counts(capsys, name, argv, want):
    """The port's CLI on the CPU: the Results line, and stdout that the
    measurement harness's parse_result reads."""
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert f"Results = {want}. DONE." in out
    d = parse_result(out)
    assert d["results"] == d["out-tuples"] == want
    assert d["s-size"] == int(argv[argv.index("-s") + 1])
    if name == "bpro":
        assert want <= d["filtered"] < 20000
    if name == "prho":
        assert "[SYNC] tier=cuda_prho" in out


@pytest.mark.parametrize("extra", ["materialize", "verbose", "trace"])
def test_cli_outputs(capsys, tmp_path, extra):
    """--materialize --out-file writes the pairs (read back with tblio: the
    host's pairs); --verbose prints the roofline, which has no model of the
    CPU; --engine-trace writes a profiler trace."""
    argv = ["-a", "PRO", "-q", "0.5", *SMALL]
    if extra == "materialize":
        argv += ["--materialize", "--out-file", str(tmp_path / "Out.tbl")]
    elif extra == "verbose":
        argv += ["--verbose"]
    else:
        argv += ["--engine-trace", str(tmp_path / "trace")]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    n = G.expected_uniform_match_count(20000, 0.5)
    assert parse_result(out)["results"] == n
    if extra == "materialize":
        rp, sp = tblio.read_relation(tmp_path / "Out.tbl")
        p = G.WorkloadParams(r_size=3000, s_size=20000, nthreads=4,
                             selectivity=0.5)
        rk, r_pay, sk, s_pay = G.build_workload(p)
        pay = dict(zip(rk.tolist(), r_pay.tolist()))
        want = sorted((pay[k], q) for k, q in zip(sk.tolist(), s_pay.tolist())
                      if k in pay)
        assert len(rp) == n and sorted(zip(rp.tolist(), sp.tolist())) == want
    elif extra == "verbose":
        assert "roofline: no chip model" in out
    else:
        assert any(f.endswith(".json")
                   for f in os.listdir(tmp_path / "trace"))


def test_join_costs_follow_what_ran():
    """The roofline's bytes and operations: S partitioned once or twice,
    or compacted to its survivors first; R's bitmap one bit a key."""
    c = roofline.join_costs(1000, 8000, 1000)
    assert (c["partition_S"].bytes_hbm, c["partition_S"].int_ops) == \
        (2 * 8000 * 4, 8000 * 14)
    assert (c["probe"].bytes_hbm, c["build"].bytes_hbm) == \
        (8000 * 4 + 125, 1000 * 4 + 125)
    c = roofline.join_costs(1000, 8000, 1000, passes=2)
    assert (c["partition_S"].bytes_hbm, c["partition_S"].int_ops) == \
        (4 * 8000 * 4, 8000 * (14 + 20))
    assert c["partition_R"].bytes_hbm == 2 * 1000 * 4
    c = roofline.join_costs(1000, 8000, 1000, s_live=80)
    assert (c["partition_S"].bytes_hbm, c["partition_S"].int_ops) == \
        ((8000 + 3 * 80) * 4, 8000 * 3 + 80 * 14)
    assert (c["probe"].bytes_hbm, c["probe"].int_ops) == (80 * 4 + 125,
                                                          80 * 9)


@pytest.mark.parametrize("case", ["q1", "q0.01", "prho", "filter"])
def test_verbose_roofline_bounds_only_the_bitmap_join(monkeypatch, case):
    """--verbose's bound on a card with a model: the bitmap radix join's
    four phases, sized by the survivors when the compaction ran; no bound
    for a count-table tier or a filtered join."""
    monkeypatch.setattr(roofline, "chip_model",
                        lambda: roofline.CHIPS["NVIDIA H100 80GB HBM3"])
    q = 0.01 if case == "q0.01" else 1.0
    p = G.WorkloadParams(r_size=3000, s_size=20000, nthreads=4,
                         selectivity=q)
    rk, rp, sk, sp = G.build_workload(p)
    R = Relation.from_numpy(rk, rp, device="cpu", stats=G.r_key_stats(p))
    S = Relation.from_numpy(sk, sp, device="cpu")
    bloom = BloomArgs(m=1 << 16) if case == "filter" else None
    _, st, _ = run_join("PRHO" if case == "prho" else "PRO", R, S,
                        EngineConfig(allow_dense=False), bloom)
    out = cli.roofline_lines(st, R, S, bloom is not None,
                             torch.device("cuda"))
    if case in ("prho", "filter"):
        assert out.startswith(f"roofline: no model of tier {st.tier}")
        return
    # S's one chunk is mostly padding, so the compaction runs at q = 1 too
    assert st.tier == "cuda_radix" and "compact" in st.phases
    live = int(((sk >= 1) & (sk <= 3000)).sum())
    assert live == G.expected_uniform_match_count(20000, q)
    want = roofline.join_costs(3000, 20000, 3000, s_live=live)
    chip = roofline.CHIPS["NVIDIA H100 80GB HBM3"]
    rows = out.splitlines()
    assert rows[0].startswith("roofline (H100 SXM") and len(rows) == 5
    for name, row in zip(("partition_R", "build", "partition_S", "probe"),
                         rows[1:]):
        assert row.split()[0] == name
        assert f"bound {want[name].bound_s(chip) * 1e3:8.3f} ms" in row


def test_cli_refuses_distribution_and_a_missing_card(monkeypatch):
    """--engine-devices 2 raises without a launcher (this process is one
    device: no ranks are started behind the caller's back); without a card,
    every backend but cpu raises (no quiet CPU fallback), the conf's
    backend too."""
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        cli.main(["--engine-devices", "2", *SMALL])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ([], ["--engine-backend", "auto"],
                    ["--engine-backend", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-r", "30", "-s", "200", *backend])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        confrun.run_config({"build": {"size": 30}, "probe": {"size": 200}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        unittests.main(["1", "7", "100"])


@pytest.mark.parametrize("text", CONF_TEXTS)
def test_confrun_parses_as_jax(text):
    assert confrun.parse_conf(text) == jconfrun.parse_conf(text)


def test_confrun_end_to_end(tmp_path, capsys):
    """tests/test_harness.py's NPO_st conf: the reference-validated count
    and the Wisconsin summary line."""
    conf = {"algorithm": "NPO_st", "threads": 3,
            "build": {"size": 37, "seed": 12345},
            "probe": {"size": 101, "seed": 54321, "selectivity": 0.7},
            "engine": {"use_pallas": False, "backend": "cpu"}}
    p = tmp_path / "x.conf"
    p.write_text(json.dumps(conf))
    assert confrun.main([str(p)]) == 0
    out = capsys.readouterr().out
    assert "Results = 71. DONE." in out
    assert "RUNTIME TOTAL, BUILD+PART, PART (cycles):" in out


def _fields(test, out):
    """The deterministic fields of a unittests output: test 0's collision
    columns, test 1's (h, y) line, test 2's variant, k and FPR columns."""
    lines = out.strip().splitlines()
    if test == "0":
        return [(r.split(";")[0], *r.split(";")[3:]) for r in lines]
    if test == "1":
        return lines[:1]
    return [[c.strip() for c in r.split("|")[4:8]] for r in lines
            if r.startswith("|")]


def _fpr_fields(r_keys, s_keys, seed, m, k_max):
    """Test 2's fields under the reference's own scalar filter
    (native.ref_bloom), which the JAX package's device filter equals bit for
    bit (its jitted filters take ~17 s here)."""
    fseed = int(jnative.rand_stream(seed, 1)[0])
    rows = [["bloom-filter", "bloom-hashes", "fpr_emp", "fpr_theo"]]
    for variant in ("blocked", "basic"):
        rows.append([variant, "", "", ""])
        for k in range(1, k_max + 1):
            pos = int(jnative.ref_bloom(variant, m, k, 512, fseed, r_keys,
                                        s_keys).sum())
            theo = (1.0 - (1.0 - 1.0 / m) ** (k * len(r_keys))) ** k
            rows.append(["", str(k), f"{pos / len(s_keys) * 100:.3f}%",
                         f"{theo * 100:.3f}%"])
    return rows


@pytest.mark.parametrize("argv", [["0", "7", "2000"], ["1", "7", "1000"],
                                  ["2", "817263", "2000", "500", "16384",
                                   "3"]])
def test_unittests_match_jax(capsys, monkeypatch, argv):
    """Tests 0-2 at small arguments print the JAX package's collision
    counts and final (h, y), and test 2 the FPR counts of the reference's
    filter.  Test 2's native selection sampling walks all of [0,
    INT32_MAX) whatever the sizes (~15 s), so both packages' samplers are
    replaced by one that records its arguments and returns consecutive
    keys: the port asks for the JAX package's populations (the same seeds,
    skips, sizes and ranges) and counts what the reference's filter
    counts over them."""
    if argv[0] == "2":
        calls = []

        def sampler(seed, skip, n, minv, maxv):
            calls.append((seed, skip, n, minv, maxv))
            return np.arange(minv, minv + n, dtype=np.int32), skip + n
        monkeypatch.setattr(native, "unique_gen_range", sampler)
        monkeypatch.setattr(jnative, "unique_gen_range", sampler)
        pops = unittests._fpr_populations(817263, 500, 2000)
        jpops = junittests._fpr_populations(817263, 500, 2000)
        assert calls[:2] == calls[2:] and len(calls) == 4
        for got, want in zip(pops, jpops):
            np.testing.assert_array_equal(got, want)
        calls.clear()
    assert unittests.main([*argv, "--engine-backend", "cpu"]) == 0
    got = _fields(argv[0], capsys.readouterr().out)
    if argv[0] == "2":
        assert len(calls) == 2
        assert got == _fpr_fields(*pops, 817263, 16384, 3)
        assert len(got) == 9
        return
    assert junittests.main(argv) == 0
    assert got == _fields(argv[0], capsys.readouterr().out)
    assert len(got) == {"0": 11, "1": 1}[argv[0]]
