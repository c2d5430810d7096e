"""The port's 3D setup (cubed-sphere geometry, numerical metric, DCMIP
initial states, 3D panel-edge halo) against the JAX package's, float64 on
the CPU, from the same arguments.

Tolerances: 1e-12 of each field's max for the geometry, the metric (the
fields tests/test_euler3d.py:39-50 checks) and the initial states — both
packages run the same numpy code, so they agree far inside it; 1e-14 for the
halo exchange, a permutation plus one 2x2 rotation of the same numbers."""

import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry.cubed_sphere_3d import make_cubed_sphere_3d as j_geometry
from wxfactory_tpu.geometry.metric3d import make_metric_3d as j_metric
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_operators
from wxfactory_tpu.parallel.topology import CubedSphereTopology as JTopology
from wxfactory_tpu.testcases.dcmip import acoustic_wave as j_acoustic_wave
from wxfactory_tpu.testcases.dcmip import dcmip_gravity_wave as j_gravity_wave
from wxfactory_tpu_torch.geometry import make_cubed_sphere_3d, make_metric_3d
from wxfactory_tpu_torch.ops.dfr import make_dfr_operators
from wxfactory_tpu_torch.parallel import CubedSphereTopology
from wxfactory_tpu_torch.testcases import acoustic_wave, dcmip_gravity_wave, dcmip_planet_params

torch.set_num_threads(1)

SHAPES = [(3, 2, 2), (4, 2, 3)]
CASES = {31: (j_gravity_wave, dcmip_gravity_wave), 77: (j_acoustic_wave, acoustic_wave)}
GEOMETRY_FIELDS = ("X", "Y", "eta", "height", "lon", "lat", "X_itf_i", "Y_itf_j", "eta_itf_k",
                   "height_itf_i", "height_itf_j", "height_itf_k")
METRIC_FIELDS = ("sqrtG", "inv_dzdeta", "h_contra", "christoffel", "sqrtG_itf_i", "sqrtG_itf_j",
                 "sqrtG_itf_k", "h_contra_itf_i", "h_contra_itf_j", "h_contra_itf_k")


def _geometries(nel_h, nel_v, s, case):
    scale, rotating = dcmip_planet_params(case)
    kw = dict(ztop=10000.0, planet_scaling_factor=scale, planet_is_rotating=rotating)
    return j_geometry(nel_h, nel_v, s, **kw), make_cubed_sphere_3d(nel_h, nel_v, s, **kw)


def _close(got, want, tol):
    scale = np.abs(want).max() or 1.0
    assert got.shape == want.shape
    assert np.abs(got - want).max() / scale < tol


@pytest.mark.parametrize("case", [31, 77])
@pytest.mark.parametrize("nel_h,nel_v,s", SHAPES)
def test_geometry_matches_jax(nel_h, nel_v, s, case):
    jg, g = _geometries(nel_h, nel_v, s, case)
    assert (g.earth_radius, g.rotation_speed) == (jg.earth_radius, jg.rotation_speed)
    for name in GEOMETRY_FIELDS:
        _close(getattr(g, name), getattr(jg, name), 1e-12)


@pytest.mark.parametrize("case", [31, 77])
@pytest.mark.parametrize("nel_h,nel_v,s", SHAPES)
def test_metric_matches_jax(nel_h, nel_v, s, case):
    jg, g = _geometries(nel_h, nel_v, s, case)
    jm = j_metric(jg, j_operators(s, three_d=True), JTopology(jg))
    m = make_metric_3d(g, make_dfr_operators(s, three_d=True), CubedSphereTopology(g))
    for name in METRIC_FIELDS:
        _close(getattr(m, name), getattr(jm, name), 1e-12)
    if case == 77:  # rotating planet: the time Christoffels are there
        assert np.abs(m.christoffel[:, :3]).max() > 0.0


@pytest.mark.parametrize("case", [31, 77])
@pytest.mark.parametrize("nel_h,nel_v,s", SHAPES)
def test_initial_state_matches_jax(nel_h, nel_v, s, case):
    jg, g = _geometries(nel_h, nel_v, s, case)
    j_init, init = CASES[case]
    want = j_init(jg)
    got = init(g)
    assert got.shape == (5, 6, nel_v, nel_h, nel_h, s**3)
    for v in range(5):
        _close(got[v], want[v], 1e-12)


@pytest.mark.parametrize("covariant", [False, True], ids=["contravariant", "covariant"])
@pytest.mark.parametrize("rotation", [(0.0, 0.0, 0.0), (0.3, 0.7853981633974483, 0.2)], ids=["plain", "rotated"])
def test_halo_state_3d_matches_jax(rotation, covariant):
    nel_h, nel_v, s = 4, 2, 3
    kw = dict(ztop=10000.0, planet_scaling_factor=1.0, planet_is_rotating=True)  # case 77's planet
    kw.update(zip(("lambda0", "phi0", "alpha0"), rotation))
    jg = j_geometry(nel_h, nel_v, s, **kw)
    g = make_cubed_sphere_3d(nel_h, nel_v, s, **kw)
    rng = np.random.default_rng(3)
    shape = (5, 6, nel_v, nel_h, nel_h, 2 * s * s)
    itf_i, itf_j = rng.standard_normal(shape), rng.standard_normal(shape)
    want = np.asarray(JTopology(jg).halo_state_3d(itf_i, itf_j, (1, 2), covariant=covariant))
    got = CubedSphereTopology(g).halo_state_3d(torch.as_tensor(itf_i), torch.as_tensor(itf_j), (1, 2),
                                                covariant=covariant).numpy()
    assert got.shape == want.shape == (5, 4, 6, nel_v, nel_h, s * s)
    _close(got, want, 1e-14)
    scalars = CubedSphereTopology(g).halo_scalars_3d(torch.as_tensor(itf_i[0]), torch.as_tensor(itf_j[0]))
    j_scalars = JTopology(jg).halo_scalars_3d(itf_i[0], itf_j[0])
    for side in range(4):
        _close(scalars[side].numpy(), np.asarray(j_scalars[side]), 1e-14)


def test_unported_cases_raise():
    from wxfactory_tpu_torch.testcases import initial_state_3d

    g = make_cubed_sphere_3d(3, 2, 2, 10000.0)
    for case in (11, 12, 20, 21, 22):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            initial_state_3d(g, case)
