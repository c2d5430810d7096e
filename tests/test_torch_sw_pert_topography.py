"""The shallow-water perturbation form with bottom topography (Williamson
cases 5 and 10) against the JAX package, on the CPU, where the wrappers run
the plain torch versions (the card's perturbation kernel with topography is
held against them in tests/test_torch_kernel_cuda.py and chip_smoke.py
phase 35).

* float64 at (nel, s) = (4, 3) and (3, 2): the RHS on the absolute state,
  ``delta`` and a stage with x (on the deltas) against the JAX
  ``make_rhs_shallow_water(..., topo, perturbation_base=q0,
  interior="xla")`` (its ``rhs_pert``, ``.delta``), within 1e-12 of each
  variable's term scale (the max of inv_sqrtG * div(F)); the base planes
  carry the topography (the traces of h0 + hsurf less each interface's
  hsurf), and a base with topography refuses a call without its planes.
* float32 at the bench's 4-step drift state (bench.py:425-446): the f32
  perturbation form with topography against the f64 truth, within twice
  the JAX f32 form's own error and below the f32 absolute form's; case 5
  within the bench's gate 5e-3 of the tendency scale. Case 10's tendency is
  about a hundredth of case 5's (its flow is near steady), and there the
  JAX f32 perturbation form itself sits at 1.1e-2 of it (the f32 absolute
  form 4.8e-2), a property of the reference.
* The float32 mixed companion of case 5 and 10 through ``Simulation``:
  EPI3 + ``kiops_jit`` with ``mixed_precision_krylov = 1`` against the JAX
  ``Simulation`` on the same INI within 2e-5 of each variable's max (the
  case-6 mixed test's bound, tests/test_torch_sw_epi.py), and one Ros2 +
  ``fgmres_jit`` mixed step within the same.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.geometry import make_cubed_sphere_2d as j_geom
from wxfactory_tpu.geometry import make_metric_2d as j_metric
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_ops
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.testcases import case_unsteady_zonal as j_case10
from wxfactory_tpu.testcases import williamson_case5 as j_case5
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.kernels import check
from wxfactory_tpu_torch.ops import sw_operator as swop
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)

GATE_REL = 5e-3  # bench.py:309
DT = 600.0


def _case(case, nel, s):
    geom = j_geom(nel, s)
    ops = j_ops(s)
    q0, topo = (j_case5 if case == 5 else j_case10)(geom, ops)
    return geom, ops, j_metric(geom), np.asarray(q0), topo


def _scaled(got, want, scale):
    return float((np.abs(np.asarray(got, np.float64) - np.asarray(want)).reshape(3, -1).max(axis=1)
                  / np.asarray(scale)).max())


@pytest.mark.parametrize("case", [5, 10])
@pytest.mark.parametrize("nel,s", [(4, 3), (3, 2)], ids=["4x3", "3x2"])
def test_perturbation_form_with_topography_matches_jax(case, nel, s):
    geom, ops, metric, q0, topo = _case(case, nel, s)
    dq = check.sw_delta(q0)
    x = 1e-3 * q0 * np.random.default_rng(5).standard_normal(q0.shape)
    jrhs = j_make_rhs(geom, ops, metric, topo=topo, interior="xla", perturbation_base=jnp.asarray(q0))
    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=q0, topo=topo)
    assert rhs.base.topography and rhs.topo is not None
    term = check.flux_divergence_scale(torch.as_tensor(q0 + dq), rhs.con).numpy()

    want_delta = np.asarray(jrhs.delta(jnp.asarray(dq)))
    assert _scaled(rhs.delta(torch.as_tensor(dq)).numpy(), want_delta, term) < 1e-12
    want_rhs = np.asarray(jrhs(jnp.asarray(q0 + dq)))
    assert _scaled(rhs(torch.as_tensor(q0 + dq)).numpy(), want_rhs, term) < 1e-12
    a, b, cdt = 0.75, 0.25, 0.25 * DT
    got, traces = rhs.stage(torch.as_tensor(x), torch.as_tensor(dq), a, b, cdt)
    assert traces is None
    assert _scaled(got.numpy(), a * x + b * dq + cdt * want_delta, cdt * term) < 1e-12
    # The absolute form of the same RHS is the absolute operator with topography.
    absolute = interop.shallow_water_rhs(geom, ops, metric, topo=topo)
    q = torch.as_tensor(q0 + dq)
    torch.testing.assert_close(rhs.xla(q), absolute(q), rtol=0, atol=0)
    # The base's traces and halo hold h0 + hsurf less each interface's hsurf:
    # the JAX package's interface states at the base.
    con, topology = rhs.con, rhs.topology
    qL_x, _, _, qR_y = swop._interface_states(rhs.base.itf0, rhs.base.halo0, s)
    hq0 = swop._with_hsurf(torch.as_tensor(q0), rhs.topo)
    jL_x, _, _, jR_y = swop._without_hsurf(
        swop._interface_states(hq0 @ con.ee, swop._halo_of(hq0, None, con, topology), s), rhs.topo)
    torch.testing.assert_close(qL_x, jL_x, rtol=1e-14, atol=0)
    torch.testing.assert_close(qR_y, jR_y, rtol=1e-14, atol=0)
    # A base with topography runs with its planes only.
    with pytest.raises(ValueError, match="with topography"):
        swop.sw_operator(torch.as_tensor(dq), None, con, base=rhs.base, topology=topology)


@pytest.mark.parametrize("case", [5, 10])
def test_f32_pert_topography_at_drift_state(case):
    """bench.py:425-446 at (10, 3): the f32 perturbation RHS with topography
    at the IC advanced four f64 TVD-RK3 steps (dt = 150 s), base = the IC."""
    nel, s = 10, 3
    geom, ops, metric, q0, topo = _case(case, nel, s)
    rhs64 = jax.jit(j_make_rhs(geom, ops, metric, topo=topo, interior="xla"))
    qt, dt = jnp.asarray(q0), 150.0
    for _ in range(4):
        k1 = qt + dt * rhs64(qt)
        k2 = 0.75 * qt + 0.25 * (k1 + dt * rhs64(k1))
        qt = qt / 3.0 + (2.0 / 3.0) * (k2 + dt * rhs64(k2))
    truth = np.asarray(rhs64(qt))
    scale = np.abs(truth).reshape(3, -1).max(axis=1)
    j32 = j_make_rhs(geom, ops, metric, topo=topo, dtype=jnp.float32, interior="xla",
                     perturbation_base=jnp.asarray(q0))
    err_jax = _scaled(j32.delta((qt - j32.base_state).astype(jnp.float32)), truth, scale)
    r32 = interop.shallow_water_rhs(geom, ops, metric, dtype=torch.float32, perturbation_base=q0, topo=topo)
    qt_t = torch.as_tensor(np.array(qt))
    err = _scaled(r32.delta((qt_t - r32.base_state.double()).float()).numpy(), truth, scale)
    a32 = interop.shallow_water_rhs(geom, ops, metric, dtype=torch.float32, topo=topo)
    err_abs = _scaled(a32(qt_t.float()).numpy(), truth, scale)
    print(f"case {case}: f32 perturbation with topography {err:.3e} (JAX {err_jax:.3e}), f32 absolute "
          f"{err_abs:.3e} of tendency scale")
    assert err < 2.0 * err_jax and err < err_abs
    if case == 5:
        assert err < GATE_REL


INI = """
[General]
equations = shallow_water
[System]
distribute = off
[Test_case]
case_number = {case}
[Time_integration]
dt = 1800
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = kiops_jit
linear_solver = fgmres_jit
mixed_precision_krylov = 1
tolerance = 1e-7
verbose_solver = 1
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Grid]
grid_type = cubed_sphere
[Output_options]
output_dir = {out}
"""


@pytest.mark.parametrize("case,integrator,steps", [(5, "epi3", 2), (10, "epi3", 1), (5, "ros2", 1)],
                         ids=["case5_epi3", "case10_epi3", "case5_ros2"])
def test_mixed_companion_with_topography_matches_jax(tmp_path, case, integrator, steps):
    text = INI.format(case=case, t_end=1800.0 * steps, integrator=integrator, out=tmp_path)
    with contextlib.redirect_stdout(io.StringIO()):
        want = np.asarray(JSimulation(JConfiguration(text)).run())
    with contextlib.redirect_stdout(io.StringIO()) as log:
        sim = Simulation(Configuration(text), device="cpu")
        got = sim.run().numpy()
    assert "no effect" not in log.getvalue() and "cannot consume" not in log.getvalue()
    assert sim.rhs32 is not None and sim.rhs32.dtype == torch.float32
    assert sim.rhs32.base.topography and sim.rhs32.topo is not None
    scale = np.abs(want).reshape(3, -1).max(axis=1)
    assert _scaled(got, want, scale) < 2e-5
