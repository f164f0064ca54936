"""The check that decides ``correct`` fails its control and the faults
that a cell can have."""

import dataclasses

import pytest

from hwbloomradixjoin_tpu_torch.models import registry
from joinbench import control, datagen, run

CELLS = ["brj_flagship.bloom", "workload_b.pro", "brj_flagship.nofilter",
         "workload_b.prho"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload, tiny):
    _, config, traffic, _ = tiny(workload)
    rel = datagen.make(config, 2**31 + 21, "cpu")
    out = control.readings(rel, config, traffic)
    assert out["correct"] is False
    assert out["checks"]["count_gap"]["value"] > \
        out["checks"]["count_gap"]["limit"]


class Faulty:
    """A plan whose answers are altered where they are produced."""

    def __init__(self, plan, count_delta=0, s_after=None):
        self.plan, self.count_delta, self._s_after = plan, count_delta, \
            s_after

    @property
    def s_after(self):
        return self.plan.s_after if self._s_after is None else self._s_after

    def full(self):
        out = self.plan.full()
        return out + self.count_delta if out.dim() == 0 else \
            out + out.new_tensor([self.count_delta, 0, 0])


def altered(name, R, S, cfg, bloom):
    """A query whose count is off by one."""
    plan, tier = registry.plan_join(name, R, S, cfg, bloom)
    return Faulty(plan, count_delta=1), tier


def half(name, R, S, cfg, bloom):
    """A query that joins half of S and leaves the rest out."""
    n = S.key.numel() // 2
    S = dataclasses.replace(S, key=S.key[:n], payload=S.payload[:n])
    return registry.plan_join(name, R, S, cfg, bloom)


def unfiltered(name, R, S, cfg, bloom):
    """A query whose prune returns S unchanged."""
    plan, tier = registry.plan_join(name, R, S, cfg, None)
    return Faulty(plan, s_after=S.key.numel()), tier


FAULTS = [(w, f) for w in CELLS for f in (altered, half)] \
    + [("brj_flagship.bloom", unfiltered)]


@pytest.mark.parametrize("workload,fault", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f in FAULTS])
def test_fault_is_not_correct(workload, fault, tiny):
    cell, config, traffic, per_layer = tiny(workload)
    out = run.execute(cell, config, traffic, per_layer, 2**31 + 9, 0.05,
                      False, "cpu", plan_join=fault)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] > 0
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
