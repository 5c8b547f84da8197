"""Vectorized SAGIN constellation propagation and coverage extraction.

Re-implements the seed's per-satellite/per-region Python loops
(``core/constellation.py``) as batched array operations over
``(n_regions, n_times, n_sats)``.  The two key optimisations:

1. **Basis factoring.** Every circular-orbit position is linear in
   ``(cos nt, sin nt)`` (angle addition on ``u = u0 + nt``) and every
   rotating ground target is affine in ``(cos Ot, sin Ot)``.  The whole
   ``(R, T, N)`` satellite-target dot-product field therefore factors
   into one ``(T, 6) @ (6, N)`` GEMM per region over precomputed
   constant bases — transcendentals are evaluated on ``O(T + N)``
   values instead of ``O(T * N)`` per region.
2. **Visibility without arcsin.** On a spherical Earth the elevation is
   monotone in the satellite-target central angle, so the minimum
   elevation maps to a scalar dot-product threshold
   ``a R cos(psi_max)`` with ``psi_max = acos(R cos e / a) - e``.
   Thresholding the GEMM output directly replaces the seed's
   per-sample norm + arcsin passes.

Interval extraction is a single padded-diff over the whole ``(T, N)``
visibility mask per region instead of a Python loop over satellites;
the emitted :class:`AccessInterval` lists are bit-identical in ordering
and boundary convention to the seed implementation (kept below as
:func:`access_intervals_loop` for equivalence tests and benchmarks).

Backends: ``"numpy"`` (the default of :func:`access_intervals_multi`:
window boundaries are control-plane state) or ``"torch"``, which builds
the harmonics and the Gram on ``device``, runs the GEMM and the
threshold there in float64, and copies the boolean mask back once for
the NumPy interval extraction.  ``"auto"`` is ``"torch"`` on the card
and raises without one; nothing falls back to NumPy.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.constellation import (AccessInterval, R_EARTH, OMEGA_EARTH,
                                  WalkerStar, elevation_angles)
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Region:
    """A ground target region served by its own FL orchestration."""
    name: str
    lat_deg: float
    lon_deg: float
    min_elevation_deg: float = 15.0


def resolve_backend(backend: str = "auto",
                    device="cuda") -> Optional[torch.device]:
    """The device the batched propagation math runs on: ``None`` for
    NumPy, else the torch device (``"auto"``: the card).  Raises when
    the card is asked for and absent."""
    if backend == "numpy":
        return None
    if backend == "torch":
        return resolve_device(device)
    if backend == "auto":
        return resolve_device("cuda")
    if backend == "jax":
        raise ValueError("backend='jax' belongs to the JAX package; the "
                         "port's accelerator backend is 'torch'")
    raise ValueError(f"backend must be 'auto', 'numpy' or 'torch', "
                     f"got {backend!r}")


# ---------------------------------------------------------------------------
# Batched geometry -----------------------------------------------------------
# ---------------------------------------------------------------------------
def _freeze(arr: np.ndarray) -> np.ndarray:
    """Mark a memoized array read-only: cached basis operands are shared
    across every caller, so accidental in-place edits must fail loudly."""
    arr.flags.writeable = False
    return arr


@lru_cache(maxsize=128)
def constellation_basis(ws: WalkerStar) -> np.ndarray:
    """Linear basis B, shape (2, n_sats, 3), with
    ``pos(t) = cos(nt) * B[0] + sin(nt) * B[1]``.

    Derived by angle addition on the argument of latitude
    ``u = u0 + n t`` of ``WalkerStar.positions_eci``; the basis is a
    pure function of the (frozen, hashable) constellation geometry, so
    it is memoized per constellation — the engine's event loop calls
    into the propagation pass once per region step, and rebuilding the
    GEMM operands each time was pure waste.  The returned array is
    read-only.
    """
    inc = np.deg2rad(ws.inclination_deg)
    S, P = ws.sats_per_plane, ws.n_planes
    raan = np.pi * np.arange(P) / P                              # (P,)
    base_u = 2 * np.pi * np.arange(S) / S                        # (S,)
    phase = 2 * np.pi * ws.phasing / ws.n_sats
    u0 = base_u[None, :] + phase * np.arange(P)[:, None]         # (P,S)
    cu, su = np.cos(u0), np.sin(u0)
    a = ws.semi_major
    ci, si = np.cos(inc), np.sin(inc)
    cr = np.cos(raan)[:, None]
    sr = np.sin(raan)[:, None]
    # cos(nt) coefficients of (x, y, z)
    b0 = np.stack([a * (cu * cr - su * ci * sr),
                   a * (cu * sr + su * ci * cr),
                   a * su * si], axis=-1)                        # (P,S,3)
    # sin(nt) coefficients of (x, y, z)
    b1 = np.stack([a * (-su * cr - cu * ci * sr),
                   a * (-su * sr + cu * ci * cr),
                   a * cu * si], axis=-1)
    return _freeze(np.stack([b0.reshape(ws.n_sats, 3),
                             b1.reshape(ws.n_sats, 3)]))         # (2,N,3)


def region_basis(regions: Sequence[Region]) -> np.ndarray:
    """Affine basis D, shape (R, 3, 3), with
    ``tgt_r(t) = cos(Ot) * D[r, 0] + sin(Ot) * D[r, 1] + D[r, 2]``.

    Memoized per region tuple (``Region`` is frozen/hashable); the
    returned array is read-only.
    """
    return _region_basis_cached(tuple(regions))


@lru_cache(maxsize=128)
def _region_basis_cached(regions: Tuple[Region, ...]) -> np.ndarray:
    lat = np.deg2rad([r.lat_deg for r in regions])
    lon = np.deg2rad([r.lon_deg for r in regions])
    cl, sl = np.cos(lat), np.sin(lat)
    co, so = np.cos(lon), np.sin(lon)
    zeros = np.zeros_like(cl)
    d0 = np.stack([R_EARTH * cl * co, R_EARTH * cl * so, zeros], axis=-1)
    d1 = np.stack([-R_EARTH * cl * so, R_EARTH * cl * co, zeros], axis=-1)
    d2 = np.stack([zeros, zeros, R_EARTH * sl], axis=-1)
    return _freeze(np.stack([d0, d1, d2], axis=1))               # (R,3,3)


@lru_cache(maxsize=128)
def _target_gram(ws: WalkerStar, regions: Tuple[Region, ...]) -> np.ndarray:
    """Contracted basis G, shape (R, 6, n_sats) — the constant GEMM
    operand of :func:`target_dots`, memoized per (constellation,
    regions) pair.  Read-only."""
    b = constellation_basis(ws)                                  # (2,N,3)
    d = region_basis(regions)                                    # (R,3,3)
    g = np.einsum("kns,rms->rkmn", b, d)                         # (R,2,3,N)
    return _freeze(g.reshape(len(regions), 6, ws.n_sats))


def positions_eci_batch(ws: WalkerStar, t: np.ndarray):
    """ECI satellite positions, shape (T, n_sats, 3): one small GEMM."""
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    basis = constellation_basis(ws)                              # (2,N,3)
    w = ws.mean_motion
    coeff = np.stack([np.cos(w * t), np.sin(w * t)], axis=-1)    # (T,2)
    pos = coeff @ basis.reshape(2, -1)                           # (T, N*3)
    return pos.reshape(len(t), ws.n_sats, 3)


def targets_eci_batch(regions: Sequence[Region], t: np.ndarray):
    """ECI positions of rotating ground targets, shape (R, T, 3)."""
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    basis = region_basis(regions)                                # (R,3,3)
    coeff = np.stack([np.cos(OMEGA_EARTH * t), np.sin(OMEGA_EARTH * t),
                      np.ones_like(t)], axis=-1)                 # (T,3)
    return np.einsum("tm,rms->rts", coeff, basis)


def target_dots(ws: WalkerStar, regions: Sequence[Region], t: np.ndarray):
    """Satellite-target dot products ``r_sat . r_tgt``, (R, T, n_sats).

    ``dot(r,t,n) = sum_{k,m} C(t,k) E(t,m) G(r,k,m,n)`` where C/E are the
    orbital/Earth-rotation harmonics and G contracts the two constant
    bases — i.e. one (T, 6) @ (6, N) GEMM per region.
    """
    t = np.atleast_1d(np.asarray(t, dtype=np.float64))
    g = _target_gram(ws, tuple(regions))                         # (R,6,N)
    w = ws.mean_motion
    c = np.stack([np.cos(w * t), np.sin(w * t)], axis=-1)        # (T,2)
    e = np.stack([np.cos(OMEGA_EARTH * t), np.sin(OMEGA_EARTH * t),
                  np.ones_like(t)], axis=-1)                     # (T,3)
    f = (c[:, :, None] * e[:, None, :]).reshape(len(t), 6)       # (T,6)
    return f @ g                                                 # (R,T,N)


@lru_cache(maxsize=128)
def _target_gram_on(ws: WalkerStar, regions: Tuple[Region, ...],
                    device: torch.device) -> torch.Tensor:
    """:func:`_target_gram` as a float64 tensor on ``device``, memoized
    per (constellation, regions, device)."""
    return torch.tensor(_target_gram(ws, regions), device=device)


def target_dots_torch(ws: WalkerStar, regions: Sequence[Region],
                      t: np.ndarray, device: torch.device) -> torch.Tensor:
    """:func:`target_dots` on ``device``: the (T, 6) harmonics and the
    (R, 6, N) Gram are float64 tensors there, and so is the product."""
    t = torch.as_tensor(np.atleast_1d(np.asarray(t, dtype=np.float64)),
                        device=device)
    g = _target_gram_on(ws, tuple(regions), device)              # (R,6,N)
    w = ws.mean_motion
    c = torch.stack([torch.cos(w * t), torch.sin(w * t)], dim=-1)
    e = torch.stack([torch.cos(OMEGA_EARTH * t), torch.sin(OMEGA_EARTH * t),
                     torch.ones_like(t)], dim=-1)
    f = (c[:, :, None] * e[:, None, :]).reshape(len(t), 6)       # (T,6)
    dot = f @ g                                                  # (R,T,N)
    _require_float64(dot)
    return dot


def sin_elevations(ws: WalkerStar, regions: Sequence[Region], t: np.ndarray,
                   backend: str = "numpy", device="cuda") -> np.ndarray:
    """sin(elevation) of every satellite from every region, (R, T, n_sats),
    as a NumPy array.

    ``sin(elev) = (dot / R_E - R_E) / |r_sat - r_tgt|`` with
    ``|r_sat - r_tgt|^2 = a^2 + R_E^2 - 2 dot`` (law of cosines).
    """
    dev = resolve_backend(backend, device)
    a = ws.semi_major
    if dev is None:
        dot = target_dots(ws, regions, t)
        dist = np.sqrt(a * a + R_EARTH * R_EARTH - 2.0 * dot)
        return (dot / R_EARTH - R_EARTH) / dist
    dot = target_dots_torch(ws, regions, t, dev)
    dist = torch.sqrt(a * a + R_EARTH * R_EARTH - 2.0 * dot)
    return ((dot / R_EARTH - R_EARTH) / dist).cpu().numpy()


def coverage_dot_threshold(ws: WalkerStar, min_elevation_deg: float) -> float:
    """Dot-product threshold equivalent to the elevation mask.

    Elevation >= e  <=>  central angle <= psi_max  <=>
    ``r_sat . r_tgt >= a R cos(psi_max)`` with
    ``psi_max = acos((R/a) cos e) - e`` (law of sines in the
    Earth-center / target / satellite triangle).
    """
    e = np.deg2rad(min_elevation_deg)
    a = ws.semi_major
    psi_max = np.arccos(R_EARTH / a * np.cos(e)) - e
    return float(a * R_EARTH * np.cos(psi_max))


def visibility(ws: WalkerStar, regions: Sequence[Region], t: np.ndarray,
               backend: str = "auto", device="cuda") -> np.ndarray:
    """Boolean visibility mask, (R, T, n_sats), as a NumPy array.  On the
    torch backend the threshold runs on ``device`` and only the mask
    comes back."""
    dev = resolve_backend(backend, device)
    thresh = np.asarray([coverage_dot_threshold(ws, r.min_elevation_deg)
                         for r in regions])
    if dev is None:
        dot = target_dots(ws, regions, t)
        return np.asarray(dot >= thresh[:, None, None])
    dot = target_dots_torch(ws, regions, t, dev)
    mask = dot >= torch.as_tensor(thresh, device=dev)[:, None, None]
    return mask.cpu().numpy()


# ---------------------------------------------------------------------------
# Vectorized interval extraction ---------------------------------------------
# ---------------------------------------------------------------------------
def _require_float64(dot: torch.Tensor) -> None:
    """Interval extraction demands float64 dot products: in float32 (a
    cast, or a TF32 product) coverage-window boundaries shift by a ``dt``
    sample.  Fail loudly instead."""
    if dot.dtype != torch.float64:
        raise ValueError(
            f"the torch propagation backend computes in float64, got "
            f"{dot.dtype}; in float32 interval boundaries shift by one "
            f"dt sample")


def intervals_from_visibility(visible: np.ndarray,
                              t: np.ndarray) -> List[AccessInterval]:
    """Extract coverage windows from a (T, n_sats) visibility mask.

    One padded diff over the whole mask replaces the seed's per-satellite
    loop; boundary conventions match the seed exactly (interval end is
    the first non-visible sample, clamped to ``t[-1]`` for windows still
    open at the horizon), including the (start, sat) ordering.
    """
    v = np.asarray(visible, dtype=bool)
    if not v.any():
        # all-invisible mask (tight elevation mask, polar region, short
        # horizon): skip the diff + double lexsort entirely
        return []
    T, N = v.shape
    pad = np.zeros((1, N), dtype=np.int8)
    d = np.diff(v.astype(np.int8), axis=0, prepend=pad, append=pad)
    start_t, start_s = np.nonzero(d == 1)     # first visible sample index
    end_t, end_s = np.nonzero(d == -1)        # first non-visible sample index
    # pair rises with falls per satellite (lexsort: time within satellite)
    so = np.lexsort((start_t, start_s))
    eo = np.lexsort((end_t, end_s))
    start_t, start_s = start_t[so], start_s[so]
    end_t = np.minimum(end_t[eo], T - 1)      # horizon-open windows
    out = [AccessInterval(sat=int(s), start=float(t[a]), end=float(t[b]))
           for s, a, b in zip(start_s, start_t, end_t)]
    out.sort(key=lambda iv: iv.start)         # stable: ties stay sat-ascending
    return out


def access_intervals_multi(ws: WalkerStar, regions: Sequence[Region],
                           t_end: float = 6 * 3600.0, dt: float = 10.0,
                           backend: str = "numpy", device="cuda"
                           ) -> Dict[str, List[AccessInterval]]:
    """Coverage windows for every region from ONE shared propagation pass.

    Defaults to the NumPy backend: interval boundaries are
    precision-critical control-plane state.  ``backend="torch"`` (on
    ``device``) or ``"auto"`` (on the card) computes visibility on the
    device in float64 and gives the same windows.
    """
    t = np.arange(0.0, t_end, dt)
    vis = visibility(ws, regions, t, backend=backend,
                     device=device)                              # (R,T,N)
    return {r.name: intervals_from_visibility(vis[i], t)
            for i, r in enumerate(regions)}


def access_intervals_vec(ws: WalkerStar, lat_deg: float = 40.0,
                         lon_deg: float = -86.0, t_end: float = 6 * 3600.0,
                         dt: float = 10.0, min_elevation_deg: float = 15.0,
                         backend: str = "numpy", device="cuda"
                         ) -> List[AccessInterval]:
    """Single-region entry point with the seed ``access_intervals`` API."""
    region = Region("target", lat_deg, lon_deg, min_elevation_deg)
    return access_intervals_multi(ws, [region], t_end=t_end, dt=dt,
                                  backend=backend, device=device)["target"]


# ---------------------------------------------------------------------------
# Seed reference implementation (per-satellite Python loop) ------------------
# ---------------------------------------------------------------------------
def access_intervals_loop(ws: WalkerStar, lat_deg: float = 40.0,
                          lon_deg: float = -86.0, t_end: float = 6 * 3600.0,
                          dt: float = 10.0,
                          min_elevation_deg: float = 15.0
                          ) -> List[AccessInterval]:
    """The seed's per-satellite loop, preserved verbatim as the reference
    for equivalence tests and the ``benchmarks/sim_scale.py`` baseline."""
    t = np.arange(0.0, t_end, dt)
    elev = elevation_angles(ws, lat_deg, lon_deg, t)
    visible = elev >= np.deg2rad(min_elevation_deg)
    out: List[AccessInterval] = []
    for s in range(ws.n_sats):
        v = visible[:, s]
        if not v.any():
            continue
        starts = list(np.flatnonzero(v[1:] & ~v[:-1]) + 1)
        ends = list(np.flatnonzero(~v[1:] & v[:-1]) + 1)
        if v[0]:
            starts = [0] + starts
        if v[-1]:
            ends = ends + [len(t) - 1]
        for i0, i1 in zip(starts, ends):
            out.append(AccessInterval(sat=s, start=float(t[i0]),
                                      end=float(t[i1])))
    out.sort(key=lambda iv: iv.start)
    return out
