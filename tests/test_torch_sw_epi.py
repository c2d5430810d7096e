"""The port's shallow-water exponential and Rosenbrock paths (canonical run
1, tests/test_canonical_configs.py:28-39 of the JAX package: Williamson
case 6, EPI3 + PMEX, dt = 1800 s, tolerance 1e-7) against the JAX package,
on the CPU, where the Jacobian action is the plain tangent
(``torch.func.jvp`` of the plain operator; the card launches the tangent
kernel). Case 6 at nel = 4, s = 3, float64, from the same numpy state.

* EPI3 + ``pmex`` through the port's ``Simulation`` (its INI, its step:
  the 10 Epi2 bootstrap substeps, then two EPI3 steps with the history
  residual) against the JAX ``Epi``: the same Krylov iterations, substeps
  and rejections at every step, states within 1e-9 of each variable's max
  (the bound of tests/test_torch_epi.py).
* The production form (``kiops_jit``, ``mixed_precision_krylov = 1``: the
  float32 perturbation-form companion, whose Arnoldi J.v is the absolute
  float32 operator's) against the JAX ``Epi(kiops_jit, rhs32=...)`` with
  the ``interior="xla"`` companion of its simulation.py:148-154: within
  2e-5 of each variable's max (tests/test_torch_epi_kiops_jit.py's bound),
  no warning that the knob has no effect.
* One Ros2 step (``fgmres_jit`` and host ``fgmres``) and three EpiStiff3
  steps (``pmex``) against the JAX integrators: the same iteration counts,
  within 1e-9.
* The CLI on a case-6 EPI3 INI prints one ``pmex converged`` line an EPI3
  step, and its last checkpoint equals the ``Simulation``'s state, finite
  with 7,500 < h < 11,000 (the JAX canonical test's bounds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.integrators import Epi as JEpi
from wxfactory_tpu.integrators import EpiStiff as JEpiStiff
from wxfactory_tpu.integrators import Ros2 as JRos2
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.testcases import williamson_case6
from wxfactory_tpu_torch import __main__ as cli
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.integrators import EpiStiff, Ros2
from wxfactory_tpu_torch.ops import sw_operator as swop
from wxfactory_tpu_torch.output.state import load_state
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)

NEL, S, DT, TOL = 4, 3, 1800.0, 1e-7

INI = """
[General]
equations = shallow_water
[System]
distribute = off
[Test_case]
case_number = 6
[Time_integration]
dt = 1800
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = {solver}
mixed_precision_krylov = {mixed}
tolerance = 1e-7
verbose_solver = 1
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Grid]
grid_type = cubed_sphere
[Output_options]
save_state_freq = {save}
stat_freq = 0
output_dir = {out}
"""


def _ini(out, integrator="epi3", solver="pmex", mixed=0, steps=3, save=0):
    return INI.format(t_end=DT * steps, integrator=integrator, solver=solver, mixed=mixed, save=save, out=out)


def _setup():
    geom = make_cubed_sphere_2d(NEL, S)
    ops = make_dfr_operators(S)
    metric = make_metric_2d(geom)
    return geom, ops, metric, np.asarray(williamson_case6(geom))


def _stats(integ):
    info = integ.solver_info or integ.init_method.solver_info  # a bootstrap step reports its Epi2's
    return info.total_num_it, info.num_substeps, info.num_rejected


def _scaled_err(got, want):
    scale = np.abs(want).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    return float(np.abs((got - want) / scale).max())


def _jax_epi(solver, steps, mixed=False, cls=JEpi, **kw):
    geom, ops, metric, q0 = _setup()
    rhs32 = (j_make_rhs(geom, ops, metric, dtype=jnp.float32, interior="xla", perturbation_base=jnp.asarray(q0))
             if mixed else None)
    integ = cls(j_make_rhs(geom, ops, metric), order=3, exponential_solver=solver, tolerance=TOL, rhs32=rhs32, **kw)
    q, stats = jnp.asarray(q0), []
    for _ in range(steps):
        q = integ.step(q, DT)
        stats.append(_stats(integ))
    return np.asarray(q), stats


def _simulation_steps(text, steps):
    sim = Simulation(Configuration(text), device="cpu")
    q, t, stats = sim.initial_q, 0.0, []
    for step_id in range(1, steps + 1):
        q, t = sim.step(q, step_id, t)
        stats.append(_stats(sim.integrator))
    return sim, q.numpy(), stats


def test_epi3_pmex_simulation_matches_jax(tmp_path):
    want, want_stats = _jax_epi("pmex", 3, init_substeps=10)
    plain = swop.plain_tangent_calls
    sim, got, stats = _simulation_steps(_ini(tmp_path), 3)
    assert sim.integrator.exponential_solver == "pmex" and sim.integrator.init_substeps == 10
    assert sim.rhs32 is None
    assert stats == want_stats
    assert _scaled_err(got, want) < 1e-9
    assert swop.plain_tangent_calls > plain  # the CPU's Jacobian action is the plain tangent


def test_kiops_jit_mixed_matches_jax_companion(tmp_path, capsys):
    want, _ = _jax_epi("kiops_jit", 3, mixed=True, init_substeps=10)
    sim, got, _ = _simulation_steps(_ini(tmp_path, solver="kiops_jit", mixed=1), 3)
    assert sim.rhs32 is not None and sim.rhs32.dtype == torch.float32 and sim.rhs32.base is not None
    assert "no effect" not in capsys.readouterr().out
    assert _scaled_err(got, want) < 2e-5


@pytest.mark.parametrize("linear_solver", ["fgmres_jit", "fgmres"])
def test_ros2_step_matches_jax(linear_solver):
    geom, ops, metric, q0 = _setup()
    jinteg = JRos2(j_make_rhs(geom, ops, metric), tolerance=TOL, gmres_restart=20, linear_solver=linear_solver)
    want = np.asarray(jinteg.step(jnp.asarray(q0), DT))
    integ = Ros2(interop.shallow_water_rhs(geom, ops, metric), tolerance=TOL, gmres_restart=20,
                 linear_solver=linear_solver)
    got = integ.step(interop.to_tensor(q0), DT).numpy()
    assert integ.solver_info.converged
    assert integ.solver_info.total_num_it == jinteg.solver_info.total_num_it
    assert _scaled_err(got, want) < 1e-9


def test_epi_stiff3_matches_jax():
    want, want_stats = _jax_epi("pmex", 3, cls=JEpiStiff)
    geom, ops, metric, q0 = _setup()
    integ = EpiStiff(interop.shallow_water_rhs(geom, ops, metric), order=3, exponential_solver="pmex",
                     tolerance=TOL)
    q, stats = interop.to_tensor(q0), []
    for _ in range(3):
        q = integ.step(q, DT)
        stats.append(_stats(integ))
    assert stats == want_stats
    assert _scaled_err(q.numpy(), want) < 1e-9


def test_cli_epi3_pmex_run(tmp_path, capsys):
    steps = 2
    ini = tmp_path / "case6_epi3.ini"
    ini.write_text(_ini(tmp_path / "out", steps=steps, save=steps))
    assert cli.main([str(ini), "--device", "cpu"]) == 0
    log = capsys.readouterr().out
    # One line an EPI3 step; the bootstrap's Epi2 substeps run silent (as
    # in the JAX package, whose init_method takes no verbose either).
    assert log.count("pmex converged at iteration") == steps - 1
    assert f"Completed {steps} steps" in log
    sim = Simulation(Configuration(_ini(tmp_path / "out", steps=steps, save=steps)), device="cpu")
    got, config, _ = load_state(sim.output.state_file_name(steps))
    assert config.exponential_solver == "pmex"
    _, want, _ = _simulation_steps(_ini(tmp_path / "again", steps=steps), steps)
    assert _scaled_err(got, want) < 1e-13
    h = got[0]
    assert np.isfinite(got).all() and 7500.0 < h.min() and h.max() < 11000.0
