"""The port's Walker-Star propagation against the reference's.

The NumPy backend is a copy of the reference's; the torch backend runs
the harmonics, the GEMM and the threshold in float64 on a torch device
(the CPU here, the card in ``chip_smoke.py``).  Both are held to the
reference's ``access_intervals_multi`` with identical intervals (count
and every ``(sat, start, end)``), and ``sin_elevations`` to 1e-12.
"""
import numpy as np
import pytest
import torch

from repro.core.constellation import WalkerStar as JaxWalkerStar
from repro.scenarios import get_scenario as jax_get_scenario
from repro.sim import propagation as JP
from repro_torch.core.constellation import WalkerStar, access_intervals
from repro_torch.scenarios import get_scenario
from repro_torch.sim import propagation as P


def _as_tuples(ivs):
    return [(iv.sat, iv.start, iv.end) for iv in ivs]


def _reference(name):
    scn = jax_get_scenario(name)
    return JP.access_intervals_multi(scn.build_constellation(), scn.regions,
                                     t_end=scn.horizon, dt=scn.dt)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("name", ["paper", "mega_constellation",
                                  "multi_region"])
def test_intervals_identical_to_reference(name, backend):
    want = _reference(name)
    got = get_scenario(name).build_intervals(backend=backend, device="cpu")
    assert list(got) == list(want)
    for region in want:
        assert len(got[region]) == len(want[region]) > 0
        assert _as_tuples(got[region]) == _as_tuples(want[region])


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_sin_elevations_match_reference(backend):
    scn = get_scenario("multi_region")
    jscn = jax_get_scenario("multi_region")
    t = np.arange(0.0, 6 * 3600.0, 10.0)
    want = JP.sin_elevations(jscn.build_constellation(), jscn.regions, t)
    got = P.sin_elevations(scn.build_constellation(), scn.regions, t,
                           backend=backend, device="cpu")
    assert got.shape == want.shape == (4, len(t), 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_vectorized_matches_reference_loop(backend):
    """Against the seed's per-satellite loop (arcsin elevations) over 6 h,
    and through the restored ``core.constellation.access_intervals``."""
    want = JP.access_intervals_loop(JaxWalkerStar(), t_end=6 * 3600.0)
    got = P.access_intervals_vec(WalkerStar(), t_end=6 * 3600.0,
                                 backend=backend, device="cpu")
    assert _as_tuples(got) == _as_tuples(want)
    assert _as_tuples(P.access_intervals_loop(WalkerStar())) \
        == _as_tuples(want)
    assert _as_tuples(access_intervals(WalkerStar())) == _as_tuples(want)


def test_torch_backend_computes_in_float64():
    ws = WalkerStar()
    regions = get_scenario("paper").regions
    dot = P.target_dots_torch(ws, regions, np.arange(0.0, 600.0, 10.0),
                              torch.device("cpu"))
    assert dot.dtype == torch.float64
    # float64 GEMMs of 6 terms in another order: a few ulps of |dot| ~ a R
    want = P.target_dots(ws, regions, np.arange(0.0, 600.0, 10.0))
    np.testing.assert_allclose(dot.numpy(), want, rtol=0,
                               atol=1e-13 * np.abs(want).max())
    with pytest.raises(ValueError, match="float64"):
        P._require_float64(dot.float())


@pytest.mark.parametrize("backend", ["auto", "torch"])
def test_card_backends_raise_without_a_card(backend):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        P.access_intervals_multi(WalkerStar(), get_scenario("paper").regions,
                                 t_end=600.0, backend=backend)


def test_jax_backend_raises_naming_torch():
    with pytest.raises(ValueError, match="'torch'"):
        P.access_intervals_multi(WalkerStar(), get_scenario("paper").regions,
                                 t_end=600.0, backend="jax")
    with pytest.raises(ValueError, match="backend"):
        P.resolve_backend("cupy")
