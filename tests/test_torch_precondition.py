"""The port's preconditioners (``precondition/``: lu, ilu, p-mg, fv-mg)
against the JAX package's, on the CPU (each level's Jacobian action the
plain tangent there; the tangent kernel pairs, the SW pair also at s = 1,
on the card: tests/test_torch_kernel_cuda.py, chip_smoke.py phases 31 and
33). Their solves: tests/test_torch_precondition_solve.py and
tests/test_torch_ros2_precondition.py.

* One V-cycle of p-mg (shallow water at nel = 4, s = 3, two levels; 3D
  Euler dcmip31 at 3x2x3 and dt = 30 s, two levels) and of fv-mg (shallow
  water, three levels: DG(3), FV on 8 and on 4 elements a panel edge)
  against the JAX ``Multigrid`` on the same vector, for every smoother
  (erk1, erk3, ark3, exp, kiops; 3D: erk3 and kiops), within 1e-10 of the
  result's max, at a linearisation point with seeded noise.
* lu and ilu (``Factorization``) against the JAX factorization, and the
  dense Jacobian (``solvers.eigenvalue_util.jacobian_matrix``) against the
  JAX one, at nel = 2, s = 2.
* ``preconditioner = fv`` raises the JAX package's ValueError.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.geometry import make_cubed_sphere_2d as j_geom
from wxfactory_tpu.geometry import make_cubed_sphere_3d as j_geom3
from wxfactory_tpu.geometry import make_metric_2d as j_metric
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_ops
from wxfactory_tpu.precondition import Factorization as JFactorization
from wxfactory_tpu.precondition import Multigrid as JMultigrid
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.solvers.eigenvalue_util import gen_matrix as j_gen_matrix
from wxfactory_tpu.solvers.eigenvalue_util import jacobian_matrix as j_jacobian_matrix
from wxfactory_tpu.testcases import dcmip_gravity_wave as j_dcmip31
from wxfactory_tpu.testcases import williamson_case6 as j_case6
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.geometry import make_cubed_sphere_2d, make_cubed_sphere_3d
from wxfactory_tpu_torch.precondition import Factorization, Multigrid
from wxfactory_tpu_torch.simulation import Simulation
from wxfactory_tpu_torch.solvers.eigenvalue_util import gen_matrix, jacobian_matrix, save_spectrum

torch.set_num_threads(1)

SMOOTHERS = ["erk1", "erk3", "ark3", "exp", "kiops"]


def _max_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _vcycle_pair(jgeom, tgeom, q, kind, smoother, num_levels, seed=5, dt=1800.0, **kw):
    """One V-cycle of the JAX and of the port's Multigrid on the same
    seeded vector, prepared at q with the step dt."""
    kw = dict(kind=kind, num_levels=num_levels, num_pre_smoothe=1, num_post_smoothe=1, pseudo_cfl=20.0,
              smoother=smoother, **kw)
    jmg = JMultigrid.for_geometry(jgeom, **kw)
    mg = Multigrid.for_geometry(tgeom, device="cpu", **kw)
    jmg.prepare(dt, jnp.asarray(q))
    mg.prepare(dt, torch.as_tensor(q))
    v = np.random.default_rng(seed).standard_normal(q.size)
    return mg(torch.as_tensor(v)).numpy(), np.asarray(jmg(v)), mg


def _noisy(q0, seed=11):
    """q0 plus seeded noise of 1e-3 of each variable's max: case 6's hu2 and
    dcmip31's winds are zero to rounding on lines where an interface's
    split Mach number then sits within rounding of its kink at 0, where
    two correct Jacobian actions may take different sides (the inputs of
    kernels/check.py::sw_tangent_inputs)."""
    q0 = np.asarray(q0)
    scale = 1e-3 * np.abs(q0).reshape(q0.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (q0.ndim - 1))
    return q0 + scale * np.random.default_rng(seed).standard_normal(q0.shape)


@pytest.fixture(scope="module")
def sw43():
    jg = j_geom(4, 3)
    return jg, make_cubed_sphere_2d(4, 3), _noisy(j_case6(jg))


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_sw_pmg_vcycle_matches_jax(sw43, smoother):
    jg, tg, q = sw43
    got, want, mg = _vcycle_pair(jg, tg, q, "p-mg", smoother, 2)
    assert [lv.num_solpts for lv in mg.levels] == [3, 2]
    assert all(lv.preps == 1 and lv.applies > 0 for lv in mg.levels)
    assert _max_err(got, want) < 1e-10


@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_sw_fvmg_vcycle_matches_jax(sw43, smoother):
    jg, tg, q = sw43
    got, want, mg = _vcycle_pair(jg, tg, q, "fv-mg", smoother, 3)
    assert [lv.num_solpts for lv in mg.levels] == [3, 1, 1]
    assert [lv.rhs.con.nel for lv in mg.levels] == [4, 8, 4]
    assert _max_err(got, want) < 1e-10


@pytest.mark.parametrize("smoother", ["erk3", "kiops"])
def test_euler3d_pmg_vcycle_matches_jax(smoother):
    jg = j_geom3(3, 2, 3, 10000.0)
    tg = make_cubed_sphere_3d(3, 2, 3, 10000.0)
    got, want, mg = _vcycle_pair(jg, tg, _noisy(j_dcmip31(jg)), "p-mg", smoother, 2, dt=30.0)
    assert [lv.num_solpts for lv in mg.levels] == [3, 2]
    assert _max_err(got, want) < 1e-10


def _small_sw():
    geom, ops = j_geom(2, 2), j_ops(2)
    metric = j_metric(geom)
    q = _noisy(j_case6(geom))
    return geom, ops, metric, q, j_make_rhs(geom, ops, metric, interior="xla"), interop.shallow_water_rhs(
        geom, ops, metric)


def test_jacobian_matrix_matches_jax(tmp_path):
    _, _, _, q, jrhs, trhs = _small_sw()
    want = j_jacobian_matrix(jrhs, jnp.asarray(q))
    got = jacobian_matrix(trhs, torch.as_tensor(q))
    assert got.shape == (q.size, q.size) and _max_err(got, want) < 1e-12
    # gen_matrix probes any flat operator; save_spectrum writes its eigenvalues
    m = np.random.default_rng(2).standard_normal((40, 40))
    probed = gen_matrix(lambda v: torch.as_tensor(m) @ v, 40, chunk=16)
    assert np.array_equal(probed, j_gen_matrix(lambda v: m @ v, 40, chunk=16))
    vals = save_spectrum(probed, str(tmp_path / "spectrum.npz"))
    assert np.allclose(np.sort_complex(vals), np.sort_complex(np.linalg.eigvals(m)))
    assert np.allclose(np.load(tmp_path / "spectrum.npz")["eigenvalues"], vals)


@pytest.mark.parametrize("kind", ["lu", "ilu"])
def test_factorization_matches_jax(kind):
    _, _, _, q, jrhs, trhs = _small_sw()
    jf, tf = JFactorization(jrhs, kind), Factorization(trhs, kind)
    jf.prepare(1800.0, jnp.asarray(q))
    tf.prepare(1800.0, torch.as_tensor(q))
    v = np.random.default_rng(1).standard_normal(q.size)
    assert _max_err(tf(torch.as_tensor(v)).numpy(), jf(v)) < 1e-10


SW_INI = """
[General]
equations = shallow_water
[System]
distribute = off
[Test_case]
case_number = 5
[Time_integration]
dt = 3600
t_end = 7200
time_integrator = ros2
tolerance = 1e-7
gmres_restart = 30
verbose_solver = 1
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Grid]
grid_type = cubed_sphere
[Preconditioning]
preconditioner = {pre}
num_mg_levels = 2
mg_smoother = kiops
pseudo_cfl = 720
[Output_options]
output_dir = {out}
"""


def test_fv_preconditioner_raises_as_jax(tmp_path):
    text = SW_INI.format(pre="fv", out=tmp_path)
    with pytest.raises(ValueError, match="Preconditioner 'fv' is not available"):
        JSimulation(JConfiguration(text))
    with pytest.raises(ValueError, match="Preconditioner 'fv' is not available"):
        Simulation(Configuration(text), device="cpu")
