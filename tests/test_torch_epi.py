"""The port's exponential integrators (``wxfactory_tpu_torch.integrators.Epi``,
KIOPS, the Jacobian action through ``Euler3DRHS.jtv`` — the plain tangent
on the CPU) against the JAX package's ``Epi`` (KIOPS, ``jax.jvp`` of the XLA
RHS), float64, at the shape of tests/test_canonical_configs.py:42: dcmip31
on 4x2 elements, s=2, planet scale 125, not rotating, dt = 30 s, tolerance
1e-7, mmin 16, mmax 64.

* Four EPI2 steps and three EPI3 steps (the first one the Epi2 bootstrap of
  the multistep history, the next two with the history residuals): the same
  Krylov iterations, substeps and rejections at every step, and final
  states within 1e-9 of each variable's max. The adaptivity is
  integer-valued, so a different operator or controller shows as a
  different count; the states then carry the two RHSs' ~1e-13 round-off
  difference through the Krylov recurrence.
* The port's CLI on a dcmip31 ``epi2`` INI against the JAX ``Simulation`` on
  the same INI: the checkpoints agree to 1e-9 of scale, mass drifts by less
  than 1e-12, and the per-step Krylov summary is printed.
* EPI3 on shallow water (case 6 through ``Simulation``) against the JAX
  ``Epi`` within 1e-9 (more: tests/test_torch_sw_epi.py), and dcmip31 EPI2
  with ``pmex`` and ``pmex_1s`` with the JAX ``Epi``'s Krylov statistics;
  ``kiops_ne`` raises the JAX package's ``ValueError`` at the step;
  ``mixed_precision_krylov``
  with kiops warns that it has no effect (kiops_jit:
  tests/test_torch_epi_kiops_jit.py).
"""

import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.integrators import Epi as JEpi
from wxfactory_tpu.integrators import EpiStiff as JEpiStiff
from wxfactory_tpu.integrators.epi import alpha_coeff as j_alpha_coeff
from wxfactory_tpu.models import make_rhs_euler_cubesphere
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.testcases import dcmip_gravity_wave
from wxfactory_tpu_torch import __main__ as cli
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.integrators import Epi, EpiStiff
from wxfactory_tpu_torch.integrators.epi import alpha_coeff
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.output import global_mass_3d
from wxfactory_tpu_torch.output.state import load_state
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)

DT = 30.0


@pytest.fixture(scope="module")
def canonical():
    from conftest import cs3d_setup

    geom, ops, topo, metric = cs3d_setup(4, 2, 2)
    return geom, ops, topo, metric, dcmip_gravity_wave(geom)


def _stats(integ):
    info = integ.solver_info or integ.init_method.solver_info  # a bootstrap step reports its Epi2's
    return info.total_num_it, info.num_substeps, info.num_rejected


def _scaled_err(got, want):
    scale = np.abs(want).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    return float(np.abs((got - want) / scale).max())


@pytest.mark.parametrize("order,steps", [(2, 4), (3, 3)], ids=["epi2-4steps", "epi3-3steps"])
def test_epi_kiops_matches_jax(canonical, order, steps):
    geom, ops, topo, metric, q0 = canonical
    jinteg = JEpi(make_rhs_euler_cubesphere(geom, ops, metric, topo), order=order, exponential_solver="kiops",
                  tolerance=1e-7)
    q, want_stats = np.asarray(q0), []
    for _ in range(steps):
        q = jinteg.step(q, DT)
        want_stats.append(_stats(jinteg))

    integ = Epi(interop.euler3d_rhs(geom, ops, metric), order=order, exponential_solver="kiops", tolerance=1e-7)
    qt, got_stats = interop.to_tensor(q0), []
    for _ in range(steps):
        qt = integ.step(qt, DT)
        got_stats.append(_stats(integ))
    assert got_stats == want_stats
    assert integ.krylov_size == jinteg.krylov_size  # the warm start
    assert _scaled_err(qt.numpy(), np.asarray(q)) < 1e-9


INI = """
[General]
equations = euler
[System]
distribute = off
[Test_case]
case_number = 31
[Time_integration]
dt = 30
t_end = {t_end}
time_integrator = epi2
exponential_solver = kiops
tolerance = 1e-7
verbose_solver = 1
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 4
num_elements_vertical = 2
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = {steps}
output_dir = {out}
"""


def test_cli_epi2_run_matches_jax_simulation(tmp_path, capsys):
    steps = 2
    text = lambda out: INI.format(t_end=DT * steps, steps=steps, out=out)
    want = np.asarray(JSimulation(JConfiguration(text(tmp_path / "jax"))).run())
    capsys.readouterr()
    ini = tmp_path / "dcmip31_epi2.ini"
    ini.write_text(text(tmp_path / "torch"))
    plain = e3op.plain_tangent_calls
    assert cli.main([str(ini), "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    assert log.count("kiops converged at iteration") == steps
    assert e3op.plain_tangent_calls > plain  # the CPU's Jacobian action is the plain tangent

    sim = Simulation(Configuration(text(tmp_path / "torch")), device="cpu")
    got, config, _ = load_state(sim.output.state_file_name(steps))
    assert config.time_integrator == "epi2"
    assert _scaled_err(got, want) < 1e-9
    m0 = global_mass_3d(sim.initial_q, sim.ops, sim.metric)
    assert abs(global_mass_3d(got, sim.ops, sim.metric) - m0) / abs(m0) < 1e-12


def test_epi_on_shallow_water_raises(tmp_path):
    text = """
[General]
equations = shallow_water
[System]
distribute = off
[Test_case]
case_number = 6
[Time_integration]
dt = 1800
t_end = 3600
time_integrator = epi3
exponential_solver = kiops
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 3
[Grid]
grid_type = cubed_sphere
[Output_options]
output_dir = {out}
""".format(out=tmp_path)
    # EPI3 on shallow water runs now (the SW Jacobian action): the bootstrap
    # and one EPI3 step against the JAX Epi on the same grid.
    from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
    from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs_sw
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.testcases import williamson_case6
    from wxfactory_tpu_torch.models import make_rhs_shallow_water

    sim = Simulation(Configuration(text), device="cpu")
    assert isinstance(sim.integrator, Epi) and sim.integrator.n_prev == 1
    got = sim.run().numpy()
    geom = make_cubed_sphere_2d(3, 3)
    ops, metric = make_dfr_operators(3), make_metric_2d(geom)
    jinteg = JEpi(j_make_rhs_sw(geom, ops, metric), order=3, exponential_solver="kiops", tolerance=1e-7,
                  init_substeps=10)
    q = np.asarray(williamson_case6(geom))
    for _ in range(2):
        q = jinteg.step(q, 1800.0)
    want = np.asarray(q)
    scale = np.abs(want).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    assert float(np.abs((got - want) / scale).max()) < 1e-9
    # The perturbation form with topography (the mixed companion of cases 5
    # and 10) builds on shallow water too: at its base its RHS is the
    # absolute RHS with topography.
    from wxfactory_tpu.testcases import williamson_case5

    q5, topo = williamson_case5(geom, ops)
    q5 = torch.as_tensor(np.asarray(q5))
    pert = make_rhs_shallow_water(geom, ops, metric, device="cpu", topo=interop.sw_topography_fields(topo),
                                  perturbation_base=q5.numpy())
    absolute = interop.shallow_water_rhs(geom, ops, metric, topo=topo)(q5)
    assert pert.base.topography
    torch.testing.assert_close(pert(q5), absolute, rtol=0, atol=1e-12 * float(absolute.abs().max()))


@pytest.mark.parametrize("solver", ["pmex", "pmex_1s", "kiops_ne"])
def test_unported_exponential_solvers_raise(tmp_path, solver, canonical):
    text = INI.format(t_end=30, steps=0, out=tmp_path).replace("exponential_solver = kiops",
                                                               f"exponential_solver = {solver}")
    if solver == "kiops_ne":
        # The schema lists it and neither package's solvers export it: the
        # Simulation constructs, and the step raises the JAX package's
        # ValueError (integrators/epi.py:350-351 there).
        sim = Simulation(Configuration(text), device="cpu")
        with pytest.raises(ValueError, match="Unrecognized exponential solver kiops_ne"):
            sim.step(sim.initial_q, 1, 0.0)
        return
    # pmex and pmex_1s (pmex in both packages) are ported: one dcmip31 EPI2
    # step through Simulation against the JAX Epi, with the same Krylov
    # statistics.
    geom, ops, topo, metric, q0 = canonical
    jinteg = JEpi(make_rhs_euler_cubesphere(geom, ops, metric, topo), order=2, exponential_solver=solver,
                  tolerance=1e-7)
    want = np.asarray(jinteg.step(np.asarray(q0), DT))
    sim = Simulation(Configuration(text), device="cpu")
    got, _ = sim.step(sim.initial_q, 1, 0.0)
    assert sim.integrator.exponential_solver == solver
    assert _stats(sim.integrator) == _stats(jinteg)
    assert _scaled_err(got.numpy(), want) < 1e-9


def test_mixed_precision_knob_warns_it_has_no_effect(tmp_path, capsys):
    text = INI.format(t_end=30, steps=0, out=tmp_path).replace("[Time_integration]",
                                                               "[Time_integration]\nmixed_precision_krylov = 1")
    sim = Simulation(Configuration(text), device="cpu")
    assert isinstance(sim.integrator, Epi)
    assert "WARNING: mixed_precision_krylov is set but epi2" in capsys.readouterr().out


@pytest.mark.parametrize("order", [3, 4, 5, 6])
def test_epi_tables_match_jax(canonical, order):
    geom, ops, topo, metric, q0 = canonical
    nodes = [-i for i in range(-1, 1 - order, -1)]
    np.testing.assert_array_equal(alpha_coeff(nodes), j_alpha_coeff(nodes))
    jrhs = make_rhs_euler_cubesphere(geom, ops, metric, topo)
    rhs = interop.euler3d_rhs(geom, ops, metric)
    for cls, jcls in ((Epi, JEpi), (EpiStiff, JEpiStiff)):
        integ, jinteg = cls(rhs, order), jcls(jrhs, order)
        np.testing.assert_array_equal(integ.A, jinteg.A)
        assert (integ.n_prev, integ.max_phi, integ._phi_offset) == (jinteg.n_prev, jinteg.max_phi,
                                                                    jinteg._phi_offset)
        assert isinstance(integ.init_method, Epi) and integ.init_method.n_prev == 0
