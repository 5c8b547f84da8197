# Frozen copy of src/repro_torch/core/network.py at commit ed1d7aa (unchanged but
# for this header): the NumPy control plane that the benchmark's
# reference replays to work out the dataset, partition, pools, plans and
# batches again, independently of the program under test.
"""SAGIN network model: nodes, channels, and transmission rates.

Implements the system model of Section II and the channel/rate models of
Section III-D (eqs. 14-15) of the paper. All rates are in bits/sec, times in
seconds, data sizes in #samples (converted to bits via ``q_bits``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Paper constants (Section VI-A) --------------------------------------------
# ---------------------------------------------------------------------------
F_GROUND = 1e8          # Hz, f_{G,k}
F_AIR = 1e9             # Hz, f_{A,n}
F_SAT_RANGE = (1e9, 1e10)  # Hz, f_{S,i} ~ U[1,10]e9
M_CYCLES = 3e9          # cycles/sample, m_{G}=m_{A}=m_{S}
P_GROUND = 0.1          # W
P_AIR = 1.0             # W
P_SAT = 10.0            # W
Z_ISL = 3.125e6         # bits/s, inter-satellite link rate (paper constant)
N0 = 3.98e-21           # W/Hz noise PSD
B_G2A = 1e6             # Hz per-device uplink bandwidth (paper leaves B implicit)
B_A2S = 1e7             # Hz air->satellite bandwidth
BETA0 = 1e-4            # channel gain at reference distance 1 m (-40 dB, standard)
GAMMA_G2A = 2.4         # ground-air pathloss exponent under obstacles
AIR_ALTITUDE = 20e3     # m
SAT_ALTITUDE = 800e3    # m
REGION_SIZE = 1200.0    # m (square side)


@dataclasses.dataclass
class GroundDevice:
    """A terrestrial device k in the target region."""
    index: int
    position: np.ndarray            # (2,) position in the region, meters
    f: float = F_GROUND             # CPU frequency (cycles/s)
    m: float = M_CYCLES             # cycles per sample
    p: float = P_GROUND             # transmit power (W)
    n_samples: int = 0              # |D_{G,k}^{(r)}|
    n_sensitive: int = 0            # |D_k^l| (never leaves the device)

    @property
    def n_offloadable(self) -> int:
        return max(0, self.n_samples - self.n_sensitive)


@dataclasses.dataclass
class AirNode:
    """A UAV n hovering above its cluster of ground devices."""
    index: int
    position: np.ndarray            # (2,) horizontal position, meters
    altitude: float = AIR_ALTITUDE
    f: float = F_AIR
    m: float = M_CYCLES
    p: float = P_AIR
    n_samples: int = 0              # |D_{A,n}^{(r)}|


@dataclasses.dataclass
class Satellite:
    """The i-th satellite covering the region during round r."""
    index: int
    f: float                        # CPU frequency (time-varying per paper)
    m: float = M_CYCLES
    p: float = P_SAT
    coverage_end: float = np.inf    # T_i^{(r)}: seconds from round start


@dataclasses.dataclass
class ChannelModel:
    """Channel/rate model (eq. 15 and footnote 2)."""
    bandwidth_g2a: float = B_G2A
    bandwidth_a2s: float = B_A2S
    n0: float = N0
    beta0: float = BETA0
    gamma_g2a: float = GAMMA_G2A
    rayleigh: bool = True           # False -> free-space path loss (Fig. 7)
    mc_samples: int = 4096          # Monte-Carlo samples for E[.] in eq. (15)
    seed: int = 0

    def g2a_rate(self, device: GroundDevice, air: AirNode) -> float:
        """Uplink rate Z_{k,n}^{G2A} (eq. 15), bits/s."""
        d = float(np.sqrt(np.sum((device.position - air.position) ** 2)
                          + air.altitude ** 2))
        b = self.bandwidth_g2a
        if self.rayleigh:
            rng = np.random.default_rng(self.seed + 7919 * device.index
                                        + 104729 * air.index)
            g = rng.exponential(1.0, self.mc_samples)  # |Rayleigh|^2 ~ Exp(1)
            gain = self.beta0 / d ** self.gamma_g2a * g
        else:
            gain = np.asarray([self.beta0 / d ** 2])   # LoS free-space
        snr = device.p * gain / (b * self.n0)
        return float(np.mean(b * np.log2(1.0 + snr)))

    def a2s_rate(self, air: AirNode, sat_altitude: float = SAT_ALTITUDE) -> float:
        """Air->satellite rate Z_{n,S}^{A2S}, free-space (always LoS)."""
        d = sat_altitude - air.altitude
        b = self.bandwidth_a2s
        gain = self.beta0 / d ** 2
        snr = air.p * gain / (b * self.n0)
        return float(b * np.log2(1.0 + snr))

    def s2a_rate(self, air: AirNode, sat_power: float = P_SAT,
                 sat_altitude: float = SAT_ALTITUDE) -> float:
        """Satellite->air downlink rate Z_{S,n}^{S2A} (symmetric geometry)."""
        d = sat_altitude - air.altitude
        b = self.bandwidth_a2s
        gain = self.beta0 / d ** 2
        snr = sat_power * gain / (b * self.n0)
        return float(b * np.log2(1.0 + snr))


def isl_rate(p_tx: float = P_SAT, bandwidth: float = B_A2S,
             tx_gain: float = 1e4, rx_gain: float = 1e4,
             distance: float = 2000e3, n0: float = N0,
             wavelength: float = 0.015) -> float:
    """ISL rate Z_{i,i+1} = B log2(1 + p A_tx A_rx / (C N0 B)).

    C is free-space path loss (4 pi d / lambda)^2. Defaults give ~Mbps range,
    consistent with the paper's Z_ISL = 3.125 Mbps operating point.
    """
    c = (4.0 * np.pi * distance / wavelength) ** 2
    snr = p_tx * tx_gain * rx_gain / (c * n0 * bandwidth)
    return float(bandwidth * np.log2(1.0 + snr))


@dataclasses.dataclass
class SAGIN:
    """Full network state at the start of a global round."""
    devices: List[GroundDevice]
    air_nodes: List[AirNode]
    clusters: Dict[int, List[int]]      # air index -> list of device indices
    satellites: List[Satellite]         # current + incoming, ordered
    channel: ChannelModel
    q_bits: float                       # bits per data sample
    model_bits: float                   # Q(w)
    n_sat_samples: int = 0              # |D_S^{(r)}|
    z_isl: float = Z_ISL

    # cached rates -----------------------------------------------------------
    def __post_init__(self):
        self._g2a = {}
        self._a2s = {}
        self._s2a = {}
        for n, ks in self.clusters.items():
            air = self.air_nodes[n]
            self._a2s[n] = self.channel.a2s_rate(air)
            self._s2a[n] = self.channel.s2a_rate(air)
            for k in ks:
                self._g2a[(k, n)] = self.channel.g2a_rate(self.devices[k], air)

    def g2a_rate(self, k: int, n: int) -> float:
        return self._g2a[(k, n)]

    def a2s_rate(self, n: int) -> float:
        return self._a2s[n]

    def s2a_rate(self, n: int) -> float:
        return self._s2a[n]

    def cluster_of(self, k: int) -> int:
        for n, ks in self.clusters.items():
            if k in ks:
                return n
        raise KeyError(k)

    @property
    def total_samples(self) -> int:
        return (sum(d.n_samples for d in self.devices)
                + sum(a.n_samples for a in self.air_nodes)
                + self.n_sat_samples)


def build_default_sagin(n_devices: int = 50, n_air: int = 5,
                        samples_per_device: int = 1200,
                        alpha: float = 0.8,
                        q_bits: float = 28 * 28 * 8,
                        model_bits: float = 1e6 * 32,
                        rayleigh: bool = True,
                        sat_f_list: Sequence[float] | None = None,
                        coverage_times: Sequence[float] | None = None,
                        seed: int = 0) -> SAGIN:
    """Construct the paper's Section VI-A setup."""
    rng = np.random.default_rng(seed)
    devices = []
    for k in range(n_devices):
        pos = rng.uniform(0.0, REGION_SIZE, size=2)
        ns = samples_per_device
        devices.append(GroundDevice(index=k, position=pos, n_samples=ns,
                                    n_sensitive=int(round((1 - alpha) * ns))))
    air_nodes = []
    per = n_devices // n_air
    clusters: Dict[int, List[int]] = {}
    # assign devices to air nodes by simple geographic stripes
    order = sorted(range(n_devices), key=lambda k: devices[k].position[0])
    for n in range(n_air):
        ks = order[n * per:(n + 1) * per]
        cx = float(np.mean([devices[k].position[0] for k in ks]))
        cy = float(np.mean([devices[k].position[1] for k in ks]))
        air_nodes.append(AirNode(index=n, position=np.array([cx, cy])))
        clusters[n] = list(ks)
    if sat_f_list is None:
        sat_f_list = rng.uniform(*F_SAT_RANGE, size=4)
    if coverage_times is None:
        coverage_times = [120.0 * (i + 1) for i in range(len(sat_f_list))]
    sats = [Satellite(index=i, f=float(f), coverage_end=float(t))
            for i, (f, t) in enumerate(zip(sat_f_list, coverage_times))]
    channel = ChannelModel(rayleigh=rayleigh, seed=seed)
    return SAGIN(devices=devices, air_nodes=air_nodes, clusters=clusters,
                 satellites=sats, channel=channel, q_bits=q_bits,
                 model_bits=model_bits)
