"""PyTorch port: the distributed join on torch.distributed against the JAX
package.

One world of 4 gloo CPU processes (parallel/multiproc.py, children that
import no jax) runs every case once, at D = 1, 2 and 4 (the first two as
subgroups): the sort-scan join, the blocked filter, skew handling over
tests/test_dist.py's Zipf workload, and the bitmap engine (its twins).  The
cases then check the results: every one against native.ref_join, and at D
= 4 the sort-scan runs against JAX's dist_join_count on the conftest's
virtual CPU mesh, all five outputs.  Also the sync-free local join's
geometry and flag against JAX's pure-Python planners, the skew threshold,
and the CLI's --engine-devices.  Integer results: every comparison is
exact.  No JAX interpret-mode case.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from hwbloomradixjoin_tpu.config import BloomArgs as JBloomArgs
from hwbloomradixjoin_tpu.config import BloomVariant as JBloomVariant
from hwbloomradixjoin_tpu.ops import bitmap_join as JB
from hwbloomradixjoin_tpu.parallel import dist_join as JD
from hwbloomradixjoin_tpu.parallel import mesh as jmesh
from hwbloomradixjoin_tpu_torch import cli
from hwbloomradixjoin_tpu_torch.data import native
from hwbloomradixjoin_tpu_torch.ops import bitmap_join as B
from hwbloomradixjoin_tpu_torch.parallel import mesh, multiproc, skew

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "measurements"))
from measurements.run import parse_result  # noqa: E402
from port_cpu import lean_cpu  # noqa: E402,F401  (autouse)

UNIFORM = {"r_size": 8192, "s_size": 32768, "nthreads": 4,
           "selectivity": 0.4}
ZIPF = {"r_size": 2048, "s_size": 16384, "nthreads": 2, "skew": 1.0}
BLOOM = {"variant": "blocked", "m": 1 << 18, "k": 2, "B": 512}
KINDS = {
    "sortscan": (UNIFORM, {}),
    "filtered": (UNIFORM, {"bloom": BLOOM}),
    "skewed": (ZIPF, {"pad_factor": 3.0, "skew_handling": True}),
    "pallas": (UNIFORM, {"local_engine": "pallas", "key_range": [1, 8192]}),
}
SIZES = (1, 2, 4)
PAD_KEY = -2**31


def _case(kind, n_dev):
    wl, kw = KINDS[kind]
    return multiproc.case(kind, n_dev, wl, **kw)


@pytest.fixture(scope="module")
def world():
    """rank 0's record of one 4-process gloo world that ran every case."""
    cases = [_case(kind, n) for n in SIZES for kind in KINDS]
    rec = multiproc.run_world(4, cases, device="cpu", timeout=300)
    rec["by_case"] = {(r["name"], r["n_dev"]): r["outputs"]
                      for r in rec["results"]}
    return rec


def test_world_ran_every_case_without_jax(world):
    """Every case ran on the gloo CPU world, and no rank imported jax or
    the JAX package."""
    assert world["jax_modules"] == []
    assert (world["device"], world["backend"]) == ("cpu", "gloo")
    assert set(world["by_case"]) == {(k, n) for k in KINDS for n in SIZES}


@pytest.mark.parametrize("n_dev", SIZES)
@pytest.mark.parametrize("kind", list(KINDS))
def test_dist_case_matches_ref_join(world, kind, n_dev):
    """The count, the sort-scan checksums (0 from the bitmap engine) and
    the survivors (the host filter's; -1 without a filter) equal the
    host's, with no overflow."""
    cnt, sr, ss, after = multiproc.expected(_case(kind, n_dev))
    want = [cnt, 0, 0, after, 0] if kind == "pallas" else [cnt, sr, ss,
                                                           after, 0]
    assert world["by_case"][(kind, n_dev)] == want
    assert cnt > 0
    if kind == "filtered":
        assert cnt <= after < UNIFORM["s_size"]
    if kind == "skewed":
        assert cnt == ZIPF["s_size"]


@pytest.fixture(scope="module")
def jax_mesh4(eight_devices):
    return jmesh.make_mesh(4)


@pytest.mark.parametrize("kind", ["sortscan", "filtered", "skewed"])
def test_dist_sortscan_matches_jax_at_four_devices(world, jax_mesh4, kind):
    """At D = 4 all five outputs, overflow and S-after included, equal the
    JAX package's dist_join_count on 4 devices of its CPU mesh."""
    wl, kw = KINDS[kind]
    jkw = {k: v for k, v in kw.items() if k != "bloom"}
    if "bloom" in kw:
        jkw["bloom_args"] = JBloomArgs(variant=JBloomVariant.BLOCKED,
                                       m=BLOOM["m"], k=BLOOM["k"],
                                       B=BLOOM["B"])
    want = JD.dist_join_count(jax_mesh4, *multiproc.workload(wl), **jkw)
    assert world["by_case"][(kind, 4)] == [int(w) for w in want]


@pytest.mark.parametrize("lo,hi,bits", [(1, 8192, None), (1, 1 << 20, None),
                                        (1, 16_000_000, None),
                                        (-70_000, 5_000_000, 9)])
def test_traced_geometry_matches_jax(lo, hi, bits):
    """The layouts and static windows of the sync-free join are the JAX
    package's: plan_geometry, plan_build_geometry and _traced_probe_geom's
    window rows on both sides."""
    pb, shift, slr = B.plan_geometry(lo, hi, bits, 1.0)
    assert (pb, shift, slr) == JB.plan_geometry(lo, hi, bits, 1.0)
    geo_r = B.plan_build_geometry(lo, hi, pb, shift, slr)
    assert geo_r == JB.plan_build_geometry(lo, hi, pb, shift, slr)
    for p, sh, sl in ((pb, shift, slr), geo_r):
        want = JB._traced_probe_geom(p, sh, sl, lo, B.CHUNK_ROWS, 3)
        assert B.traced_c_rows(p, B.CHUNK_ROWS) == want.c_rows


def _flag_on_host(keys, lo, hi, part_bits, shift, chunk_rows):
    """JAX's overflow test from numpy: a bucket run of a chunk longer than
    (c_rows - 1) * 128 at _traced_probe_geom's c_rows."""
    chunk = chunk_rows * 128
    c_rows = JB._traced_probe_geom(part_bits, shift, 8, lo, chunk_rows,
                                   1).c_rows
    k = np.concatenate([keys, np.full((-len(keys)) % chunk, PAD_KEY,
                                      np.int64)]).reshape(-1, chunk)
    longest = 0
    for row in k:
        row = row[(row >= lo) & (row <= hi)].astype(np.int64)
        runs = np.bincount((row - lo) >> shift, minlength=1 << part_bits)
        longest = max(longest, int(runs.max()))
    return int(longest > (c_rows - 1) * 128)


@pytest.mark.parametrize("heavy", [False, True])
def test_traced_radix_count_flag_and_count(heavy):
    """traced_radix_count's count equals ref_join's and its flag equals
    JAX's test on the same chunks (6 bits of [1, 2^24]: windows of 255 x
    128 keys); a key on 40,000 rows of S's first chunk sets it (the port
    still counts exactly)."""
    rng = np.random.default_rng(3)
    lo, hi = 1, 1 << 24
    rk = (rng.choice(hi, 200_000, replace=False) + 1).astype(np.int32)
    sk = rng.integers(lo, 2 * hi, 600_000).astype(np.int32)
    if heavy:
        sk[:40_000] = 12_345
    cnt, ovf = B.traced_radix_count(torch.from_numpy(rk),
                                    torch.from_numpy(sk), lo, hi)
    assert int(cnt) == native.ref_join(rk, rk, sk, sk)[0]
    pb, shift, slr = B.plan_geometry(lo, hi, None, 1.0)
    bits_r, shift_r, _ = B.plan_build_geometry(lo, hi, pb, shift, slr)
    want = _flag_on_host(rk, lo, hi, bits_r, shift_r, B.CHUNK_ROWS) \
        + _flag_on_host(sk, lo, hi, pb, shift, B.CHUNK_ROWS)
    assert int(ovf) == want == int(heavy)


@pytest.fixture
def world_of_one():
    group = mesh.make_mesh(1, "cpu")
    yield group
    dist.destroy_process_group()


def test_mesh_of_one_and_the_skew_threshold(world_of_one):
    """make_mesh(1) starts a gloo world of one and refuses a second device;
    heavy_dest_mask flags a destination past 2 x the mean load, which at
    D = 2 none can pass, and the split re-routes only heavy ones."""
    assert dist.get_world_size(world_of_one) == 1
    assert dist.get_backend() == "gloo" and mesh.in_mesh(world_of_one)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        mesh.make_mesh(2, "cpu")
    dest = torch.tensor([0] * 9 + [1, 2, 3], dtype=torch.int32)
    heavy = skew.heavy_dest_mask(dest, 4, world_of_one)
    assert heavy.tolist() == [True, False, False, False]
    assert not skew.heavy_dest_mask(torch.zeros(50, dtype=torch.int32), 2,
                                    world_of_one).any()
    valid = torch.arange(12) >= 8
    assert not skew.heavy_dest_mask(dest, 4, world_of_one, valid=valid).any()
    salt = torch.arange(12)
    moved = skew.split_heavy_dests(dest, heavy, 4, salt)
    assert moved.tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 0, 1, 2, 3]
    assert skew.replicate_mask_for_r(dest, heavy).sum() == 9


def test_dist_overflow_counts_only_capacity_drops(world_of_one):
    """On a world of one, an S whose heavy key sets JAX's window flag in
    traced_radix_count: both engines give ref_join's count with overflow
    0 (the kernels' twins count every run); a pad factor below 1 makes the
    sort-scan pack into buffers too small, and overflow counts the drop."""
    from hwbloomradixjoin_tpu_torch.parallel import dist_join
    rng = np.random.default_rng(3)
    lo, hi = 1, 1 << 24
    rk = (rng.choice(hi, 50_000, replace=False) + 1).astype(np.int32)
    sk = rng.integers(lo, 2 * hi, 150_000).astype(np.int32)
    sk[:40_000] = 12_345
    rp = np.arange(len(rk), dtype=np.int32)
    sp = np.arange(len(sk), dtype=np.int32)
    assert int(B.traced_radix_count(torch.from_numpy(rk),
                                    torch.from_numpy(sk), lo, hi)[1]) == 1
    cnt, sr, ss = native.ref_join(rk, rp, sk, sp)
    for engine, sums in (("sortscan", [sr % 2**32, ss % 2**32]),
                         ("pallas", [0, 0])):
        out = dist_join.dist_join_count(world_of_one, rk, rp, sk, sp,
                                        local_engine=engine,
                                        key_range=(lo, hi), device="cpu")
        assert [int(v) for v in out] == [cnt, *sums, -1, 0], engine
    out = dist_join.dist_join_count(world_of_one, rk, rp, sk, sp,
                                    pad_factor=0.5, device="cpu")
    assert int(out[4]) == len(sk) - (int(len(sk) * 0.5) + 16)


@pytest.mark.parametrize("engine", ["sortscan", "pallas"])
def test_cli_engine_devices_one_on_the_cpu(capsys, engine):
    """--engine-devices 1 --engine-backend cpu: a world of one on this
    process, torn down after; the reference's lines with the exact count
    and tier dist[1]/<engine>, no warning."""
    argv = ["-a", "PRO", "-r", "3000", "-s", "20000", "-q", "0.5",
            "--engine-devices", "1", "--engine-backend", "cpu",
            "--engine-sync-stats", "--engine-local-join", engine]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    d = parse_result(out)
    assert d["results"] == d["out-tuples"] == 10_000
    assert f"[SYNC] tier=dist[1]/{engine} " in out and "[WARN ]" not in out
    assert not dist.is_initialized()


def test_cli_engine_devices_four_raises_without_a_launcher():
    """Four devices need four ranks from a launcher: none are started
    behind the caller's back, and no world is left behind."""
    with pytest.raises(ValueError, match="need 4 devices, have 1"):
        cli.main(["-r", "3000", "-s", "20000", "--engine-devices", "4",
                  "--engine-backend", "cpu"])
    assert not dist.is_initialized()


def test_cli_ends_the_launchers_world_it_joined(capsys, monkeypatch):
    """Under a launcher's HBRJ_* environment (a world of one here) the CLI
    joins that world, runs, and destroys the group it initialized."""
    monkeypatch.setenv("HBRJ_COORDINATOR", mesh.free_address())
    monkeypatch.setenv("HBRJ_NUM_PROCS", "1")
    monkeypatch.setenv("HBRJ_PROC_ID", "0")
    assert cli.main(["-r", "3000", "-s", "20000", "--engine-devices", "1",
                     "--engine-backend", "cpu"]) == 0
    assert "Results = 20000. DONE." in capsys.readouterr().out
    assert not dist.is_initialized()
