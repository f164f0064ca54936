"""Settings of the benchmark's own tests.

``python -m pytest joinbench/tests -q`` runs them on the CPU at tiny
sizes; tests marked ``card`` need a CUDA device and skip without one (run
them on the card with the same command).
"""

import pytest
import torch

from joinbench import run


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA device (skips without one)")


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def shrink(config: dict) -> dict:
    """A configuration at a size the CPU runs in well under a second: the
    same generator, selectivity and filter variant, fewer tuples, threads
    and filter bits."""
    small = dict(config, r_size=3000, s_size=24000,
                 nthreads=min(config["nthreads"], 3))
    if small["filter"]:
        small["filter"] = dict(small["filter"], m=1 << 16)
    return small


@pytest.fixture
def tiny():
    """workload name -> (cell, tiny configuration, traffic, per-layer
    metric entries)."""
    def resolve(workload):
        cell, config, traffic, per_layer = run.resolve(workload)
        return cell, shrink(config), traffic, per_layer
    return resolve
