"""The Cartesian plane's post-step filters and multigrid families in the
port against the JAX package, on the CPU (each level's Jacobian action the
plain tangent there; the DFR and FV tangent kernels on the card:
tests/test_torch_kernel_cuda.py, chip_smoke.py phase 38):

* the Rayleigh sponge (``apply_sponge``) and the 2D exponential filter
  without a metric against ``wxfactory_tpu/ops/filters.py``'s
  ``make_apply_filters``: the sponge (an elementwise product) bit for bit,
  with the filter within 1e-14 of each variable's max (its s^2 matrix
  product sums in another order);
* the p-mg family (``cartesian_euler_levels``: DG(3), DG(2), then the FV
  level at order 1) and the fv-mg family (``cartesian_fv_mg_levels``:
  DG(4), FV on the (4 nel) sub-cell grid, then 2x agglomeration) of case 2
  at 4 x 6 elements: the levels' orders, pseudo-time scales and RHS, the
  transfers on a seeded state within 1e-13 of its max, and one V-cycle at
  a linearisation point with seeded noise against the JAX ``Multigrid`` on
  the same vector within 1e-10 of the result's max (erk3; p-mg also with
  the exp smoother).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.geometry.cartesian import make_cartesian_2d as j_make_cartesian_2d
from wxfactory_tpu.ops.filters import make_apply_filters as j_make_apply_filters
from wxfactory_tpu.precondition import Multigrid as JMultigrid
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.geometry import make_cartesian_2d
from wxfactory_tpu_torch.kernels import check
from wxfactory_tpu_torch.models import EulerCartesianFVRHS, EulerCartesianRHS
from wxfactory_tpu_torch.ops.filters import make_apply_filters
from wxfactory_tpu_torch.precondition import Multigrid
from wxfactory_tpu_torch.testcases import initialize_cartesian2d

torch.set_num_threads(1)

FILTER_INI = """
[General]
equations = euler
[Grid]
grid_type = cartesian2d
x0 = 0
x1 = 1000
z0 = 0
z1 = 1500
[Test_case]
case_number = 2
[Time_integration]
dt = 0.5
t_end = 1
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 4
num_elements_horizontal = 4
num_elements_vertical = 6
apply_sponge = 1
sponge_tscale = 10
sponge_zscale = 600
expfilter_apply = {expfilter}
expfilter_strength = 10
expfilter_order = 8
expfilter_cutoff = 0.25
"""


@pytest.mark.parametrize("expfilter", [0, 1])
def test_sponge_and_filter_match_jax(expfilter):
    text = FILTER_INI.format(expfilter=expfilter)
    geom = make_cartesian_2d((0, 1000), (0, 1500), 4, 6, 4)
    jgeom = j_make_cartesian_2d((0, 1000), (0, 1500), 4, 6, 4)
    q = check.perturbed_cartesian(initialize_cartesian2d(geom, 2), np.random.default_rng(1))
    mine = make_apply_filters(Configuration(text), None, device="cpu", geom=geom)
    theirs = j_make_apply_filters(JConfiguration(text), None, None, jgeom)
    got = mine(torch.as_tensor(q), 0.5).numpy()
    want = np.asarray(theirs(jnp.asarray(q), 0.5))
    if expfilter:
        scale = np.abs(want).reshape(4, -1).max(axis=1).reshape(4, 1, 1, 1)
        assert float((np.abs(got - want) / scale).max()) < 1e-14
    else:
        np.testing.assert_array_equal(got, want)
    # The sponge acts on rho*w only, and only above z1 - sponge_zscale.
    if not expfilter:
        np.testing.assert_array_equal(got[[0, 1, 3]], q[[0, 1, 3]])
        low = geom.X3 <= 900.0
        np.testing.assert_array_equal(got[2][low], q[2][low])
        assert np.all(np.abs(got[2][~low]) <= np.abs(q[2][~low]))


def _vcycle_pair(kind, smoother, num_levels, s, seed=5, dt=1.0):
    jgeom = j_make_cartesian_2d((0, 1000), (0, 1500), 4, 6, s)
    geom = make_cartesian_2d((0, 1000), (0, 1500), 4, 6, s)
    q = check.perturbed_cartesian(initialize_cartesian2d(geom, 2), np.random.default_rng(seed))
    kw = dict(kind=kind, num_levels=num_levels, num_pre_smoothe=1, num_post_smoothe=1, pseudo_cfl=3.0,
              smoother=smoother)
    jmg = JMultigrid.for_geometry(jgeom, **kw)
    mg = Multigrid.for_geometry(geom, device="cpu", **kw)
    jmg.prepare(dt, jnp.asarray(q))
    mg.prepare(dt, torch.as_tensor(q))
    v = np.random.default_rng(seed + 1).standard_normal(q.size)
    return mg(torch.as_tensor(v)).numpy(), np.asarray(jmg(v)), mg, jmg, q


@pytest.mark.parametrize("kind,smoother,num_levels,s", [("p-mg", "erk3", 3, 3), ("p-mg", "exp", 2, 3),
                                                        ("fv-mg", "erk3", 3, 4)])
def test_vcycle_matches_jax(kind, smoother, num_levels, s):
    got, want, mg, jmg, q = _vcycle_pair(kind, smoother, num_levels, s)
    assert [lv.num_solpts for lv in mg.levels] == [lv.num_solpts for lv in jmg.levels]
    assert [lv.tau_scale for lv in mg.levels] == [lv.tau_scale for lv in jmg.levels]
    assert isinstance(mg.levels[0].rhs, EulerCartesianRHS)
    if num_levels == 3:  # the bottom level: finite volume at order 1
        assert isinstance(mg.levels[-1].rhs, EulerCartesianFVRHS) and mg.levels[-1].num_solpts == 1
    # The transfers level by level on the state itself.
    a, ja = torch.as_tensor(q), jnp.asarray(q)
    for r, jr, p, jp in zip(mg.restricts, jmg.restricts, mg.prolongs, jmg.prolongs):
        a, ja = r(a), jr(ja)
        assert tuple(a.shape) == tuple(ja.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-13 * float(np.abs(ja).max()))
        back, jback = p(a), jp(ja)
        np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=0, atol=1e-13 * float(np.abs(jback).max()))
    assert float(np.abs(got - want).max() / np.abs(want).max()) < 1e-10
    assert all(lv.preps == 1 for lv in mg.levels) and all(lv.applies > 0 for lv in mg.levels)


def test_fv_mg_level_family():
    """fv-mg at s = 4, nel 4 x 6: DG(4), FV on 16 x 24 cells, 8 x 12, 4 x 6,
    2 x 3 (a level halves while both counts are even and the smaller is at
    least 4), as the JAX family."""
    geom = make_cartesian_2d((0, 1000), (0, 1500), 4, 6, 4)
    mg = Multigrid.for_geometry(geom, kind="fv-mg", num_levels=8, device="cpu")
    jmg = JMultigrid.for_geometry(j_make_cartesian_2d((0, 1000), (0, 1500), 4, 6, 4), kind="fv-mg", num_levels=8)
    cells = [(lv.rhs.con.ncell_x, lv.rhs.con.ncell_z) for lv in mg.levels[1:]]
    assert cells == [(16, 24), (8, 12), (4, 6), (2, 3)]
    assert len(mg.levels) == len(jmg.levels)
    assert [lv.tau_scale for lv in mg.levels] == [lv.tau_scale for lv in jmg.levels]
