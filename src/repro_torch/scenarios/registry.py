"""Named SAGIN scenario presets: constellation + regions + dynamics.

A :class:`Scenario` is the single declarative object from which
examples, tests, and benchmarks construct a full simulation — the
"as many scenarios as you can imagine" axis of the roadmap.  Presets
ship for the paper's exact setup, a mega-constellation, a multi-region
deployment, degraded links, and device churn; new scenarios register
with :func:`register` (or :func:`scenario`, its decorator form for
lazily-built variants).

    from repro_torch.scenarios import get_scenario
    scn = get_scenario("multi_region")
    engine = SAGINEngine(scn, seed=0)
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Tuple

from ..core.constellation import AccessInterval, WalkerStar
from ..fl.federation import FederationConfig
from ..obs import ObsConfig
from ..resilience import FaultPlan, FaultSpec
from ..serve.workload import ServeConfig
from ..sim.dynamics import DynamicsConfig
from ..sim.propagation import Region, access_intervals_multi


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative description of one SAGIN FL deployment."""
    name: str
    description: str
    # constellation ---------------------------------------------------------
    n_sats: int = 80
    n_planes: int = 5
    altitude: float = 800e3
    inclination_deg: float = 85.0
    phasing: int = 1
    # regions ---------------------------------------------------------------
    regions: Tuple[Region, ...] = (Region("indiana", 40.0, -86.0),)
    # per-region network population (engine defaults; FLConfig may override)
    n_devices: int = 50
    n_air: int = 5
    samples_per_device: int = 1200
    alpha: float = 0.8
    strategy: str = "adaptive"
    # dynamics --------------------------------------------------------------
    dynamics: Optional[DynamicsConfig] = None
    # observability (repro_torch.obs): an ObsConfig or a bare JSONL trace
    # path; disabled when None.  FLConfig.obs wins when both are set.
    obs: Optional[ObsConfig | str] = None
    # fault injection (repro_torch.resilience): a deterministic schedule of
    # typed faults the engine injects in FL mode — satellite loss,
    # merge-time ISL partitions, stragglers, NaN updates, trainer
    # crashes.  None (default) runs clean with zero overhead.
    faults: Optional[FaultPlan] = None
    # serving workload (repro_torch.serve): arrival process / router /
    # batching a ServeGateway attached to this scenario's engine uses.
    # FLConfig.serve wins when both are set; None means the gateway's
    # defaults.  Training never reads this field.
    serve: Optional[ServeConfig] = None
    # cross-region federation (engine FL mode) ------------------------------
    # The federation policy decides WHO merges WHAT, WHEN, at WHAT ISL
    # price (repro_torch.fl.federation): cadence, topology, staleness
    # half-life, quorum, hub election.  None keeps regions fully
    # independent (one model per region, the pre-merge behavior).
    federation: Optional[FederationConfig] = None
    # DEPRECATED: legacy spelling of federation=FederationConfig(
    # policy="synchronous", every=..., topology=..., half_life=...).
    # Kept as a shim — passing merge_every synthesizes the equivalent
    # synchronous federation config and emits one DeprecationWarning.
    merge_every: Optional[int] = None
    merge_topology: str = "ring"            # "ring" | "star" ISL route
    merge_half_life: Optional[float] = None
    # propagation window ----------------------------------------------------
    horizon: float = 48 * 3600.0
    dt: float = 10.0

    def __post_init__(self):
        from ..core.latency import MERGE_TOPOLOGIES
        if self.merge_every is not None and self.merge_every < 1:
            raise ValueError(f"{self.name}: merge_every must be a positive "
                             f"round count or None, got {self.merge_every}")
        if self.merge_topology not in MERGE_TOPOLOGIES:
            raise ValueError(f"{self.name}: merge_topology must be one of "
                             f"{MERGE_TOPOLOGIES}, got "
                             f"{self.merge_topology!r}")
        # federation= wins outright over the legacy fields: replace()d
        # copies of a legacy scenario keep merge_every around, so a
        # both-set error would break dataclasses.replace(scn,
        # federation=...) — the migration path itself
        if self.merge_every is not None and self.federation is None:
            warnings.warn(
                f"Scenario merge_every/merge_topology/merge_half_life are "
                f"deprecated; pass federation=FederationConfig("
                f"policy='synchronous', every={self.merge_every}, "
                f"topology={self.merge_topology!r}, "
                f"half_life={self.merge_half_life}) instead",
                DeprecationWarning, stacklevel=3)

    def resolved_federation(self) -> Optional[FederationConfig]:
        """The scenario's federation config, with the deprecated
        ``merge_*`` fields mapped to the equivalent ``synchronous``
        policy (trajectory-identical at equal seeds).  ``None`` means no
        cross-region merging."""
        if self.federation is not None:
            return self.federation
        if self.merge_every is None:
            return None
        return FederationConfig(policy="synchronous",
                                every=self.merge_every,
                                topology=self.merge_topology,
                                half_life=self.merge_half_life)

    def build_constellation(self) -> WalkerStar:
        if self.n_sats % self.n_planes:
            raise ValueError(f"{self.name}: n_sats={self.n_sats} not "
                             f"divisible by n_planes={self.n_planes}")
        return WalkerStar(n_sats=self.n_sats, n_planes=self.n_planes,
                          altitude=self.altitude,
                          inclination_deg=self.inclination_deg,
                          phasing=self.phasing)

    def build_intervals(self, backend: str = "numpy", device="cuda"
                        ) -> Dict[str, List[AccessInterval]]:
        """Coverage windows for every region from one shared propagation.

        NumPy (float64) by default so window boundaries are host-
        independent; see ``access_intervals_multi`` for the torch
        backend (``device`` is read only by it).
        """
        return access_intervals_multi(self.build_constellation(),
                                      self.regions, t_end=self.horizon,
                                      dt=self.dt, backend=backend,
                                      device=device)


SCENARIOS: Dict[str, Scenario] = {}


def register(scn: Scenario) -> Scenario:
    if scn.name in SCENARIOS:
        raise ValueError(f"scenario {scn.name!r} already registered")
    SCENARIOS[scn.name] = scn
    return scn


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown scenario {name!r}; available: "
                         f"{sorted(SCENARIOS)}") from None


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


# ---------------------------------------------------------------------------
# Presets --------------------------------------------------------------------
# ---------------------------------------------------------------------------
register(Scenario(
    name="paper",
    description="The paper's Section VI-A setup: 80-sat Walker-Star over "
                "one Indiana target region, deterministic network.",
))

register(Scenario(
    name="mega_constellation",
    description="Starlink-class shell: 1080 satellites in 27 planes at "
                "550 km / 53 deg serving two mid-latitude regions.",
    n_sats=1080, n_planes=27, altitude=550e3, inclination_deg=53.0,
    regions=(Region("indiana", 40.0, -86.0),
             Region("catalonia", 41.4, 2.2)),
    horizon=6 * 3600.0, dt=10.0,
))

register(Scenario(
    name="multi_region",
    description="One shared 80-sat constellation training ONE global FL "
                "model across four continents: regions merge over the "
                "ISL ring every 2 rounds with staleness-discounted "
                "weights (set federation=None for independent models; "
                "swap federation.policy for soft_async/partial/"
                "elected_hub merges).",
    regions=(Region("indiana", 40.0, -86.0),
             Region("nairobi", -1.3, 36.8),
             Region("reykjavik", 64.1, -21.9),
             Region("sydney", -33.9, 151.2)),
    n_devices=20, n_air=2,
    federation=FederationConfig(policy="synchronous", every=2,
                                topology="ring", half_life=3600.0),
    horizon=24 * 3600.0,
))

register(Scenario(
    name="degraded_links",
    description="Paper topology under hostile links: frequent ISL fades, "
                "per-cluster uplink outages, heavy weather on rates.",
    dynamics=DynamicsConfig(isl_outage_prob=0.3, isl_outage_scale=0.25,
                            uplink_outage_prob=0.2,
                            uplink_outage_delay=30.0,
                            weather_std=0.3),
))

register(Scenario(
    name="device_churn",
    description="Paper topology with unreliable ground devices (20% "
                "offline per round) and satellite compute jitter.",
    dynamics=DynamicsConfig(churn_prob=0.2, sat_freq_jitter_std=0.2),
))

register(Scenario(
    name="flash_crowd",
    description="Burst-dominated serving traffic over hostile links: "
                "three regions under the degraded_links outage profile "
                "while Gilbert-Elliott burst episodes drive 12x request "
                "spikes against a quiet baseline — the stress case for "
                "the min-response-time serving router (queues pile onto "
                "the own satellite exactly when its uplink dead-airs).",
    regions=(Region("indiana", 40.0, -86.0),
             Region("nairobi", -1.3, 36.8),
             Region("sydney", -33.9, 151.2)),
    n_devices=12, n_air=2,
    dynamics=DynamicsConfig(isl_outage_prob=0.3, isl_outage_scale=0.25,
                            uplink_outage_prob=0.2,
                            uplink_outage_delay=30.0,
                            weather_std=0.3),
    serve=ServeConfig(base_rate=1.0, diurnal_amplitude=0.2,
                      burst_markov=(0.05, 0.2), burst_multiplier=12.0,
                      router="min_rt"),
    federation=FederationConfig(policy="synchronous", every=2,
                                topology="ring", half_life=3600.0),
    horizon=24 * 3600.0,
))

register(Scenario(
    name="chaos",
    description="Resilience gauntlet: three regions under bursty "
                "Gilbert-Elliott ISL/uplink outages, heavy weather, and "
                "device churn, with a handcrafted fault schedule that "
                "exercises every repro.resilience fault kind — "
                "mid-coverage satellite loss, merge-time ISL partitions, "
                "stragglers, NaN client updates, and a trainer crash — "
                "against the recovery paths (unplanned handover re-plan, "
                "partial-quorum fallback, quarantine, warm restart).",
    regions=(Region("indiana", 40.0, -86.0),
             Region("nairobi", -1.3, 36.8),
             Region("sydney", -33.9, 151.2)),
    n_devices=12, n_air=2,
    dynamics=DynamicsConfig(isl_markov=(0.3, 0.5), isl_outage_scale=0.25,
                            uplink_markov=(0.2, 0.6),
                            uplink_outage_delay=30.0,
                            weather_std=0.2, sat_freq_jitter_std=0.2,
                            churn_prob=0.15),
    federation=FederationConfig(policy="synchronous", every=2,
                                topology="ring", half_life=3600.0),
    faults=FaultPlan(faults=(
        FaultSpec("sat_loss", round=1, region=0, severity=0.5),
        FaultSpec("straggler", round=1, region=1, severity=3.0),
        FaultSpec("isl_partition", round=2, region=2),
        FaultSpec("nan_update", round=3, region=2, severity=2.0),
        FaultSpec("trainer_crash", round=4, region=1, severity=0.5),
        FaultSpec("isl_partition", round=4, region=1),
        FaultSpec("nan_update", round=5, region=0, severity=1.0),
    )),
    horizon=24 * 3600.0,
))
