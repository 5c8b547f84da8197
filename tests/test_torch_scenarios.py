"""The port's scenario registry, network dynamics and fault schedules
against the reference's: all three are NumPy, copied with only their
imports rewritten, so every comparison here is exact."""
import dataclasses

import numpy as np
import pytest

from repro.resilience import FaultInjector as JaxFaultInjector
from repro.resilience import FaultPlan as JaxFaultPlan
from repro.scenarios import SCENARIOS as JAX_SCENARIOS
from repro.sim import region_streams as jax_region_streams
from repro_torch.resilience import FAULT_KINDS, FaultInjector, FaultPlan
from repro_torch.scenarios import SCENARIOS, get_scenario
from repro_torch.sim import region_seed, region_streams

PRESETS = ["paper", "mega_constellation", "multi_region", "degraded_links",
           "device_churn", "flash_crowd", "chaos"]


def test_registry_holds_the_seven_presets():
    assert sorted(SCENARIOS) == sorted(JAX_SCENARIOS) == sorted(PRESETS)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equal_to_reference_field_by_field(name):
    got, want = get_scenario(name), JAX_SCENARIOS[name]
    fields = [f.name for f in dataclasses.fields(want)]
    assert [f.name for f in dataclasses.fields(got)] == fields
    for field in fields:
        a, b = getattr(got, field), getattr(want, field)
        if dataclasses.is_dataclass(b) or isinstance(b, tuple):
            a, b = _plain(a), _plain(b)
        assert a == b, field
    assert got.build_constellation().__dict__ \
        == want.build_constellation().__dict__
    assert _plain(got.resolved_federation()) \
        == _plain(want.resolved_federation())


def _plain(value):
    """Dataclasses (nested in tuples too) as plain dicts and tuples."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, (tuple, list)):
        return tuple(_plain(v) for v in value)
    return value


def _events(ev):
    return (ev.round_index, ev.sat_freq_scale.tolist(), ev.isl_scale,
            ev.rate_scale, dict(ev.uplink_delays), tuple(ev.offline_devices))


@pytest.mark.parametrize("name", ["degraded_links", "device_churn",
                                  "flash_crowd", "chaos"])
def test_dynamics_event_streams_identical(name):
    """Ten rounds of every region's events at ``region_seed``: the
    orchestrator stream and the dynamics child stream of each region."""
    scn = get_scenario(name)
    for i in range(len(scn.regions)):
        rng, dyn = region_streams(5, i, scn.dynamics)
        jrng, jdyn = jax_region_streams(5, i, JAX_SCENARIOS[name].dynamics)
        assert region_seed(5, i) == 5 + 1000 * i
        for r in range(10):
            assert _events(dyn.sample_round(r, 80, 5, 50)) \
                == _events(jdyn.sample_round(r, 80, 5, 50))
        np.testing.assert_array_equal(rng.random(8), jrng.random(8))
        assert dyn.state_dict().keys() == jdyn.state_dict().keys()


def _specs(plan):
    return [dataclasses.astuple(f) for f in plan.faults]


def test_fault_schedules_identical():
    rates = {"sat_loss": 0.2, "straggler": 0.3, "nan_update": 0.1,
             "trainer_crash": 0.05, "isl_partition": 0.15}
    got = FaultPlan.generate(7, n_rounds=12, n_regions=4, rates=rates)
    want = JaxFaultPlan.generate(7, n_rounds=12, n_regions=4, rates=rates)
    assert _specs(got) == _specs(want) and len(got) > 0
    chaos, jchaos = get_scenario("chaos").faults, JAX_SCENARIOS["chaos"].faults
    inj, jinj = FaultInjector(chaos), JaxFaultInjector(jchaos)
    for r in range(8):
        assert inj.partition_at(r) == jinj.partition_at(r)
        for region in range(3):
            assert ([dataclasses.astuple(f) for f in inj.at(r, region)]
                    == [dataclasses.astuple(f) for f in jinj.at(r, region)])
    assert sorted(FAULT_KINDS) == sorted({f.kind for f in chaos.faults})
