"""Walker-Star LEO constellation and coverage-time computation.

Replaces MATLAB's ``walkerStar`` + ``accessIntervals`` (Section VI-A):
80 satellites evenly distributed across 5 circular orbits at 800 km
altitude, 85 deg inclination; target region at 40N, 86W; minimum
elevation angle 15 deg. Pure NumPy orbital geometry (spherical Earth).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

MU_EARTH = 3.986004418e14      # m^3/s^2
R_EARTH = 6371e3               # m
OMEGA_EARTH = 7.2921159e-5     # rad/s


@dataclasses.dataclass(frozen=True)
class WalkerStar:
    """Frozen (hashable) so derived geometry — the propagation engine's
    basis GEMM operands — can be memoized per constellation; derive
    variants with ``dataclasses.replace`` instead of mutating."""
    n_sats: int = 80
    n_planes: int = 5
    altitude: float = 800e3
    inclination_deg: float = 85.0
    phasing: int = 1             # inter-plane phasing factor F

    @property
    def sats_per_plane(self) -> int:
        return self.n_sats // self.n_planes

    @property
    def semi_major(self) -> float:
        return R_EARTH + self.altitude

    @property
    def mean_motion(self) -> float:
        return float(np.sqrt(MU_EARTH / self.semi_major ** 3))

    def positions_eci(self, t: np.ndarray) -> np.ndarray:
        """ECI positions, shape (len(t), n_sats, 3)."""
        t = np.atleast_1d(np.asarray(t, dtype=np.float64))
        inc = np.deg2rad(self.inclination_deg)
        S, P = self.sats_per_plane, self.n_planes
        # Star pattern: RAAN spread over 180 degrees.
        raan = np.pi * np.arange(P) / P                      # (P,)
        base_u = 2 * np.pi * np.arange(S) / S                # (S,)
        phase = 2 * np.pi * self.phasing / self.n_sats
        u0 = base_u[None, :] + phase * np.arange(P)[:, None]  # (P,S)
        u = u0[None, :, :] + self.mean_motion * t[:, None, None]  # (T,P,S)
        a = self.semi_major
        # position in orbital plane -> ECI
        cos_u, sin_u = np.cos(u), np.sin(u)
        x_orb = a * cos_u
        y_orb = a * sin_u
        ci, si = np.cos(inc), np.sin(inc)
        cr, sr = np.cos(raan), np.sin(raan)                  # (P,)
        cr = cr[None, :, None]
        sr = sr[None, :, None]
        x = x_orb * cr - y_orb * ci * sr
        y = x_orb * sr + y_orb * ci * cr
        z = y_orb * si
        pos = np.stack([x, y, z], axis=-1)                   # (T,P,S,3)
        return pos.reshape(len(t), self.n_sats, 3)


def target_eci(lat_deg: float, lon_deg: float, t: np.ndarray) -> np.ndarray:
    """ECI position of a ground target on the rotating Earth, (len(t),3)."""
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    lat = np.deg2rad(lat_deg)
    lon = np.deg2rad(lon_deg) + OMEGA_EARTH * t
    return np.stack([
        R_EARTH * np.cos(lat) * np.cos(lon),
        R_EARTH * np.cos(lat) * np.sin(lon),
        np.full_like(t, R_EARTH * np.sin(lat)),
    ], axis=-1)


def elevation_angles(constellation: WalkerStar, lat_deg: float,
                     lon_deg: float, t: np.ndarray) -> np.ndarray:
    """Elevation (rad) of every satellite seen from the target, (T, n_sats)."""
    sats = constellation.positions_eci(t)                    # (T,N,3)
    tgt = target_eci(lat_deg, lon_deg, t)[:, None, :]        # (T,1,3)
    rel = sats - tgt
    up = tgt / np.linalg.norm(tgt, axis=-1, keepdims=True)
    rel_norm = np.linalg.norm(rel, axis=-1)
    sin_elev = np.sum(rel * up, axis=-1) / rel_norm
    return np.arcsin(np.clip(sin_elev, -1.0, 1.0))


@dataclasses.dataclass
class AccessInterval:
    sat: int
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start


def access_intervals(constellation: WalkerStar, lat_deg: float = 40.0,
                     lon_deg: float = -86.0, t_end: float = 6 * 3600.0,
                     dt: float = 10.0,
                     min_elevation_deg: float = 15.0) -> List[AccessInterval]:
    """MATLAB ``accessIntervals`` equivalent: per-satellite coverage windows.

    Delegates to the vectorized multi-region engine in
    ``repro_torch.sim.propagation`` (same boundary conventions and
    ordering as the original per-satellite loop, which survives there as
    ``access_intervals_loop`` for equivalence tests and benchmarks).
    """
    from ..sim.propagation import access_intervals_vec
    return access_intervals_vec(constellation, lat_deg, lon_deg, t_end=t_end,
                                dt=dt, min_elevation_deg=min_elevation_deg)


def serving_sequence(intervals: Sequence[AccessInterval], t0: float,
                     max_sats: int = 8) -> List[AccessInterval]:
    """Greedy chain of serving satellites starting at wall-clock ``t0``.

    Picks, at each handover instant, the visible satellite with the longest
    remaining coverage; returns up to ``max_sats`` legs. These supply the
    T_i^{(r)} values for the round's latency model.
    """
    chain: List[AccessInterval] = []
    t = t0
    for _ in range(max_sats):
        candidates = [iv for iv in intervals if iv.start <= t < iv.end]
        if not candidates:
            upcoming = [iv for iv in intervals if iv.start >= t]
            if not upcoming:
                break
            nxt = min(upcoming, key=lambda iv: iv.start)
            t = nxt.start
            candidates = [nxt]
        best = max(candidates, key=lambda iv: iv.end)
        if chain and best.sat == chain[-1].sat and best.end == chain[-1].end:
            break
        chain.append(best)
        t = best.end
    return chain
