"""Port (wxfactory_tpu_torch) setup code against the JAX package: the
configuration, quadrature, DFR operators, geometry, metric and topology
tables are the same numpy/sympy code and must agree exactly; the torch halo
exchange must match the JAX one to 1e-14 (both are exact gathers plus the
same 2x2 rotation products)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.config.schema import SCHEMA as JSCHEMA
from wxfactory_tpu.geometry import make_cubed_sphere_2d as j_geom
from wxfactory_tpu.geometry import make_metric_2d as j_metric
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_dfr
from wxfactory_tpu.ops.quadrature import gauss_legendre as j_gl
from wxfactory_tpu.parallel.topology import CubedSphereTopology as JTopology
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.config.schema import SCHEMA
from wxfactory_tpu_torch.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu_torch.ops.dfr import make_dfr_operators
from wxfactory_tpu_torch.ops.quadrature import gauss_legendre
from wxfactory_tpu_torch.parallel.topology import CubedSphereTopology

torch.set_num_threads(1)

CASE6_INI = """
[General]
equations = shallow_water
[System]
desired_device = cuda
precision = float64
[Test_case]
case_number = 6
[Time_integration]
dt = 1800
t_end = 3600*24
time_integrator = epi3
exponential_solver = pmex
tolerance = 1e-7
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 10
[Grid]
grid_type = cubed_sphere
lambda0 = 0.0
phi0 = pi/4
alpha0 = 0.0
[Output_options]
stat_freq = 10
save_state_freq = 48
output_dir = results
"""

# (nel, s, lambda0, phi0, alpha0): the default grid and a rotated one.
GRIDS = [(4, 3, 0.0, 0.0, 0.0), (4, 3, 0.3, 0.7853981633974483, 0.2)]


def _equal_fields(a, b):
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(np.asarray(va), np.asarray(vb), err_msg=f.name)
        else:
            assert va == vb, f.name


def test_config_parses_case6_identically():
    a, b = Configuration(CASE6_INI), JConfiguration(CASE6_INI)
    assert [f.name for f in SCHEMA] == [f.name for f in JSCHEMA]
    for f in SCHEMA:
        assert getattr(a, f.name) == getattr(b, f.name), f.name
    assert a.state_id_params() == b.state_id_params()
    assert a.raw_text == b.raw_text


@pytest.mark.parametrize("s", [2, 3, 5])
def test_quadrature_and_dfr_operators_equal(s):
    _, pts, wts = gauss_legendre(s)
    _, jpts, jwts = j_gl(s)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(wts, jwts)
    _equal_fields(make_dfr_operators(s), j_dfr(s))


@pytest.mark.parametrize("grid", GRIDS, ids=["default", "rotated"])
def test_geometry_metric_topology_equal(grid):
    nel, s, lam, phi, alpha = grid
    g, jg = make_cubed_sphere_2d(nel, s, lam, phi, alpha), j_geom(nel, s, lam, phi, alpha)
    _equal_fields(g, jg)
    _equal_fields(make_metric_2d(g), j_metric(jg))
    t, jt = CubedSphereTopology(g), JTopology(jg)
    for name in ("_edge_src", "_flip_mask", "_conv_contra_all", "_conv_cov_all"):
        np.testing.assert_array_equal(getattr(t, name), getattr(jt, name), err_msg=name)
    for p in range(6):
        for d in range(4):
            assert (t.edges[p][d].neighbor, t.edges[p][d].flip) == (jt.edges[p][d].neighbor, jt.edges[p][d].flip)


@pytest.mark.parametrize("grid", GRIDS, ids=["default", "rotated"])
def test_torch_halo_matches_jax(grid):
    nel, s, lam, phi, alpha = grid
    jg = j_geom(nel, s, lam, phi, alpha)
    t, jt = CubedSphereTopology(make_cubed_sphere_2d(nel, s, lam, phi, alpha)), JTopology(jg)
    rng = np.random.default_rng(1234)
    arrs = [rng.standard_normal((6, nel, nel, 2 * s)) for _ in range(4)]  # itf_i/j of 2 fields
    tt = [torch.as_tensor(a) for a in arrs]
    jj = [jnp.asarray(a) for a in arrs]

    got = t.halo_scalars(tt[0], tt[1])
    want = jt.halo_scalars(jj[0], jj[1])
    for d in range(4):
        np.testing.assert_allclose(got[d].numpy(), np.asarray(want[d]), rtol=0, atol=1e-14)

    got = t.halo_vectors(*tt)
    want = jt.halo_vectors(*jj)
    scale = max(np.abs(np.asarray(want[d][c])).max() for d in range(4) for c in range(2))
    for d in range(4):
        for c in range(2):
            np.testing.assert_allclose(
                got[d][c].numpy() / scale, np.asarray(want[d][c]) / scale, rtol=0, atol=1e-14
            )
