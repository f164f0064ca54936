"""PyTorch port: the chip tools on the CPU twins.

validate_pro, build_check, part_bench, microbench and validate_key8b at a
tiny size with --engine-backend cpu: exact counts, build_check's bitmap
word for word the JAX package's XLA build_bitmap over the same keys, and
each tool (and rerun's card mode) raising without a card unless told to
run on the CPU.  The tools plan 8-row chunks here (their CHUNK_ROWS), so
each partition twin sorts 1,024 keys, not 512K.
"""

from unittest import mock

import jax
import numpy as np
import pytest
import torch

from hwbloomradixjoin_tpu.ops import bitmap_join as jbitmap_join
from hwbloomradixjoin_tpu_torch import cli
from hwbloomradixjoin_tpu_torch.measurements import rerun
from hwbloomradixjoin_tpu_torch.tools import (build_check, microbench,
                                              part_bench, validate_key8b,
                                              validate_pro)
from port_cpu import lean_cpu  # noqa: F401  (autouse)

CPU = ["--engine-backend", "cpu"]


@pytest.fixture
def small_chunks(monkeypatch):
    for tool in (validate_pro, build_check, part_bench, microbench):
        monkeypatch.setattr(tool, "CHUNK_ROWS", 8)


def test_validate_pro_counts_every_s_key(small_chunks, capsys):
    """PRO at two sizes, each count |S| (q = 1), with its plan, time and
    phases; a key outside R makes the count short and the exit 1."""
    assert validate_pro.main(["--sizes", "500x4000,700x5000", *CPU]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2
    for line, n_s in zip(out, (4000, 5000)):
        assert f"count={n_s} want={n_s} OK" in line
        assert "phases (ms): r_partition " in line and " probe " in line
    rk, sk = validate_pro.workload(np.random.default_rng(0), 500, 4000)
    assert sorted(rk) == list(range(1, 501)) and sk.min() >= 1 \
        and sk.max() <= 500

    workload = validate_pro.workload

    def short(rng, n_r, n_s):
        rk, sk = workload(rng, n_r, n_s)
        sk[:3] = n_r + 1
        return rk, sk

    with mock.patch.object(validate_pro, "workload", short):
        assert validate_pro.main(["--sizes", "500x4000", *CPU]) == 1
    assert "count=3997 want=4000 FAIL" in capsys.readouterr().out


def test_build_check_bitmap_is_jax_xla_build(small_chunks, capsys):
    """The plan's build equals, word for word, the JAX package's XLA
    build_bitmap over R's keys at the plan's build geometry; the count
    and the full count are the host's."""
    rk, sk, want = build_check.workload(3000, 20000)
    assert want == int(np.isin(sk, rk).sum())
    got = build_check.check(rk, sk, want, torch.device("cpu"))
    assert got["ok"] and got["bitmap_equal"]
    assert got["count"] == got["full"] == want
    jbm = jax.jit(lambda k: jbitmap_join.build_bitmap(
        k, 1, 3000, *got["geometry"]))(rk)
    np.testing.assert_array_equal(got["bitmap"].numpy(), np.asarray(jbm))
    assert int((got["bitmap"] != 0).sum()) > 0
    assert build_check.main(["3000", "20000", *CPU]) == 0
    out = capsys.readouterr().out
    assert "equal to the twin's" in out and f"want={want} OK" in out
    assert "build: " in out and "full join: " in out


def test_part_bench_widths_over_the_same_keys(small_chunks, capsys):
    """--widths: one line a width 1-13 over the same keys (each first
    chunk the twin's), then the fitted slopes beside the planner's
    constant."""
    assert part_bench.main(["3000", "5", "8", "1", "--widths", *CPU]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[:13]] == [
        f"partition 3000 keys bits={w} shift={13 - w}" for w in range(1, 14)]
    assert out[13].startswith("slope: ") and "SPLIT_NS_PER_BIT = 0.185" \
        in out[13] and len(out) == 14
    assert part_bench.main(["3000", "4", "7", "1", *CPU]) == 0
    assert capsys.readouterr().out.startswith(
        "partition 3000 keys bits=4 shift=7: ")
    assert part_bench.slope([1, 2, 3], [1.0, 3.0, 5.0]) == \
        pytest.approx(2.0)
    with pytest.raises(SystemExit):
        part_bench.main(["3000", "4", "7", "1", "--widths", *CPU])


def test_microbench_checks_each_primitive(small_chunks, capsys):
    """Every primitive's line, after its result was checked (sum, gather,
    scatter-add counts, sort order, kernel 1's first chunk)."""
    assert microbench.main(["--n", "4096", "--nr", "1024", *CPU]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("microbench on cpu: host-clock times")
    names = [ln.split("  ")[0] for ln in out[1:] if " ms" in ln]
    assert len(names) == 11
    assert names[0].startswith("launch latency") \
        and names[-1].startswith("partition_pass 1024 keys, a pass of 8")
    assert any(ln.startswith("geom: part_bits=0 shift=12") for ln in out)


def test_validate_key8b_takes_cuda_key8b(capsys):
    """Workload A at 1,024 x 8,192 over 16-byte tuples, S count-only: the
    cuda_key8b tier (the PRO path over the low words) and |S| matches."""
    R, S = validate_key8b.relations(1024, 8192, "cpu")
    assert R.key_hi is not None and S.key_hi is not None
    assert S.payload.numel() == 1 and S.key.numel() == 8192
    assert validate_key8b.main(["--r", "1024", "--s", "8192", *CPU]) == 0
    out = capsys.readouterr().out
    assert "tier=cuda_key8b" in out and "count=8192 expect=8192 -> OK" in out


@pytest.mark.parametrize("entry,args", [
    (validate_pro.main, ["--sizes", "500x4000"]),
    (build_check.main, ["3000", "20000"]),
    (part_bench.main, ["3000", "5", "8", "1"]),
    (microbench.main, ["--n", "4096", "--nr", "1024"]),
    (validate_key8b.main, ["--r", "1024", "--s", "8192"]),
    (rerun.main, ["card"]),
], ids=["validate_pro", "build_check", "part_bench", "microbench",
        "validate_key8b", "rerun"])
def test_entry_points_raise_without_a_card(entry, args):
    """With no card, an entry point not told --engine-backend cpu raises
    before it runs anything (cli.device_of, as the CLI's)."""
    with mock.patch("torch.cuda.is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(args)
        assert cli.device_of("cpu") == torch.device("cpu")
