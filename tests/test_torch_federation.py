"""The port's federation policies against the reference's.

Planning is NumPy in both packages: given one ``FederationState``, each
of the four built-in policies returns the same ``MergePlan``
(participants, recipients, hub, time and ISL costs identical, weights
and staleness within 1e-12).  ``MergePolicy.apply`` — the merge, through
the port's ``fedavg_pytrees`` and so the ``fedavg_agg`` op — is held to
the reference's on converted params within 1e-6.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.fl import federation as JF
from repro.models import cnn as jax_cnn
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.fl import federation as F

STATES = [
    # (policy, config kwargs, masses, clocks, isl scales, trigger)
    ("synchronous", dict(topology="ring", half_life=600.0),
     [100, 300, 100], [10.0, 40.0, 25.0], [1.0, 1.0, 1.0], None),
    ("synchronous", dict(topology="star"),
     [120, 80, 40, 60], [5.0, 9.0, 2.0, 7.5], [1.0, 0.25, 1.0, 1.0], None),
    ("partial", dict(topology="ring", quorum=0.5),
     [100, 300, 100], [10.0, 40.0, 25.0], [1.0, 0.25, 1.0], None),
    ("partial", dict(quorum=0.75),
     [1, 1, 1, 1], [0.0] * 4, [1.0, 1.0, 0.25, 0.25], None),
    ("soft_async", dict(topology="ring", half_life=600.0),
     [100, 100, 100], [40.0, 100.0, 130.0], [1.0, 1.0, 1.0], 1),
    ("soft_async", dict(half_life=60.0),
     [50, 70, 90, 20], [300.0, 120.0, 90.0, 410.0],
     [1.0, 1.0, 0.25, 1.0], 3),
    ("elected_hub", dict(topology="star", elect_by="data_mass"),
     [100, 500, 100], [0.0, 3.0, 1.0], [1.0, 1.0, 1.0], None),
    ("elected_hub", dict(elect_by="centrality", half_life=100.0),
     [900, 100, 200], [0.0, 20.0, 10.0], [0.25, 1.0, 1.0], None),
]


def _state(pkg, policy, cfg_kw, masses, clocks, scales, trigger):
    cfg = pkg.FederationConfig(policy=policy, every=1, **cfg_kw)
    regions = tuple(pkg.RegionFedState(
        index=i, name=f"r{i}", wall_clock=float(clocks[i]),
        data_mass=float(masses[i]), model_bits=32e6, z_isl=3.125e6,
        isl_scale=float(scales[i]), rounds_done=1)
        for i in range(len(masses)))
    return cfg, pkg.FederationState(config=cfg, regions=regions,
                                    barrier_round=1, trigger=trigger)


@pytest.mark.parametrize("case", range(len(STATES)))
def test_policy_plans_match_reference(case):
    policy, cfg_kw, *rest = STATES[case]
    cfg, state = _state(F, policy, cfg_kw, *rest)
    jcfg, jstate = _state(JF, policy, cfg_kw, *rest)
    got = F.get_policy(cfg).plan(state)
    want = JF.get_policy(jcfg).plan(jstate)
    if want is None:
        assert got is None
        return
    for field in ("policy", "time", "hub", "participants", "recipients",
                  "isl_costs"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_allclose(got.weights, want.weights, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.staleness, want.staleness, rtol=0,
                               atol=1e-12)


def test_registry_matches_reference():
    assert F.list_policies() == JF.list_policies()
    assert F.ELECTION_CRITERIA == JF.ELECTION_CRITERIA


@pytest.mark.parametrize("n", [1, 2, 4])
def test_apply_matches_reference(n):
    """The merge of ``n`` region models on converted params: within 1e-6
    of the reference's; one participant is the identity."""
    params, _ = jax_cnn.build_model("mnist", jax.random.PRNGKey(0),
                                    image_shape=(28, 28, 1))
    rng = np.random.default_rng(n)
    models = [jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.01 * rng.standard_normal(
            x.shape).astype(np.float32), params) for _ in range(n)]
    policy = ("synchronous", dict(half_life=600.0), [100 * (i + 1)
              for i in range(n)], [5.0 * i for i in range(n)], [1.0] * n,
              None)
    jcfg, jstate = _state(JF, *policy)
    cfg, state = _state(F, *policy)
    jpol, pol = JF.get_policy(jcfg), F.get_policy(cfg)
    want = jpol.apply(models, jpol.plan(jstate))
    port_models = [params_from_jax(m, "cpu") for m in models]
    got = pol.apply(port_models, pol.plan(state))
    if n == 1:
        assert got is port_models[0]
    got_np = params_to_numpy(got)
    for a, b in zip(jax.tree_util.tree_leaves(got_np),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    bad = dataclasses.replace(pol.plan(state), participants=(0,) * (n + 1))
    with pytest.raises(ValueError, match="participants"):
        pol.apply(port_models, bad)


def test_partition_plan_matches_reference():
    """The injected merge-time partition: capped backoff, then the
    partial-quorum plan, identical in both packages."""
    args = ("synchronous", dict(topology="ring", half_life=600.0),
            [100, 300, 100, 50], [10.0, 40.0, 25.0, 30.0], [1.0] * 4, None)
    cfg, state = _state(F, *args)
    jcfg, jstate = _state(JF, *args)
    got, delay = F.plan_under_partition(F.get_policy(cfg), state, (2,))
    want, jdelay = JF.plan_under_partition(JF.get_policy(jcfg), jstate, (2,))
    assert delay == jdelay
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
