"""The port's dcmip31 Ros2 (``integrators/rosenbrock.py``) against the JAX
package's ``Ros2``, float64 and mixed precision, on the CPU (the plain
tangent is the Jacobian action here; the card launches the tangent and
perturbation tangent kernels).

At 4x2x2, s=2, dt = 30 s, tolerance 1e-7, ``gmres_restart`` 20 (the CLI's
default), two steps from the initial state; errors per variable, scaled by
the reference's max:

* float64 with ``fgmres_jit`` and with the host ``fgmres``: identical
  iteration counts every step, states within 1e-10 of the JAX ``Ros2``'s;
* ``steps_device(q, dt, 3)`` equal to three single steps (the same solves)
  with the iteration counts summed;
* mixed precision: tests/test_torch_ros2_mixed.py;
* ``time_integrator = ros2`` through the port's ``Simulation`` on the CPU
  with ``device_step_chunk`` (the chunk runs ``steps_device``) equals the
  single steps; one ``gcrot`` step matches the JAX ``Ros2(gcrot)``; Ros2 on shallow water
  (case 6 through ``Simulation``) matches the JAX ``Ros2`` to 1e-9, and
  shallow water with topography raises naming ROADMAP.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.integrators import Ros2 as JRos2
from wxfactory_tpu.models import make_rhs_euler_cubesphere
from wxfactory_tpu.testcases import dcmip_gravity_wave
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.integrators import Ros2
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.simulation import Simulation
from wxfactory_tpu_torch.solvers import matvec

torch.set_num_threads(1)

DT, TOL, RESTART = 30.0, 1e-7, 20


def _setup(nel_h=4, nel_v=2, s=2):
    from conftest import cs3d_setup

    geom, ops, topo, metric = cs3d_setup(nel_h, nel_v, s, 10000.0)
    return geom, ops, topo, metric, dcmip_gravity_wave(geom)


def _scaled(got, want):
    """Per-variable max error scaled by the reference's max, (5,)."""
    scale = np.abs(want).reshape(5, -1).max(axis=1)
    return np.abs(got - want).reshape(5, -1).max(axis=1) / scale


@functools.lru_cache(maxsize=None)
def _jax_run(linear_solver, mixed=False, nsteps=2):
    geom, ops, topo, metric, q0 = _setup()
    rhs = make_rhs_euler_cubesphere(geom, ops, metric, topo)
    rhs32 = None
    if mixed:
        rhs32 = make_rhs_euler_cubesphere(geom, ops, metric, topo, dtype=jnp.float32, interior="xla",
                                          perturbation_base=jnp.asarray(q0))
    integ = JRos2(rhs, tolerance=TOL, gmres_restart=RESTART, linear_solver=linear_solver, rhs32=rhs32)
    q, states, iters = jnp.asarray(q0), [], []
    for _ in range(nsteps):
        q = integ.step(q, DT)
        states.append(np.asarray(q))
        iters.append(integ.solver_info.total_num_it)
    return states, iters


@functools.lru_cache(maxsize=None)
def _port_run(linear_solver, mixed=False, nsteps=2):
    """States and iteration counts of ``nsteps`` single steps, and the
    Jacobian actions and plain tangent calls they made."""
    geom, ops, topo, metric, q0 = _setup()
    rhs = interop.euler3d_rhs(geom, ops, metric)
    rhs32 = interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32, perturbation_base=q0) if mixed else None
    integ = Ros2(rhs, tolerance=TOL, gmres_restart=RESTART, linear_solver=linear_solver, rhs32=rhs32)
    q, states, iters = interop.to_tensor(q0), [], []
    actions, plain = matvec.jacobian_actions, e3op.plain_tangent_calls
    for _ in range(nsteps):
        q = integ.step(q, DT)
        states.append(q.numpy())
        iters.append(integ.solver_info.total_num_it)
        assert integ.solver_info.converged
    return states, iters, matvec.jacobian_actions - actions, e3op.plain_tangent_calls - plain


@pytest.mark.parametrize("linear_solver", ["fgmres_jit", "fgmres"])
def test_float64_ros2_matches_jax(linear_solver):
    want, jiters = _jax_run(linear_solver)
    states, iters, actions, plain = _port_run(linear_solver, nsteps=3 if linear_solver == "fgmres_jit" else 2)
    assert iters[:2] == jiters, (iters, jiters)
    for got, ref in zip(states, want):
        assert _scaled(got, ref).max() < 1e-10
    assert actions == plain > sum(iters)  # every Jacobian action one plain tangent on the CPU


def test_steps_device_equals_single_steps():
    states, iters, _, _ = _port_run("fgmres_jit", nsteps=3)
    geom, ops, topo, metric, q0 = _setup()
    integ = Ros2(interop.euler3d_rhs(geom, ops, metric), tolerance=TOL, gmres_restart=RESTART,
                 linear_solver="fgmres_jit")
    q = integ.steps_device(interop.to_tensor(q0), DT, 3)
    assert torch.equal(q, torch.as_tensor(states[-1]))
    assert integ.solver_info.total_num_it == sum(iters) and integ.num_completed_steps == 3
    assert integ.solver_info.converged and integ.failure_flag == 0


INI = """
[General]
equations = {equations}
[System]
distribute = off
[Test_case]
case_number = {case}
[Time_integration]
dt = 30
t_end = 60
time_integrator = ros2
linear_solver = {solver}
tolerance = 1e-7
device_step_chunk = 2
verbose_solver = 1
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 4
num_elements_vertical = 2
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = 0
output_dir = {out}
"""


def test_ros2_ini_through_simulation(tmp_path, capsys):
    states, iters, _, _ = _port_run("fgmres_jit", nsteps=3)
    sim = Simulation(Configuration(INI.format(equations="euler", case=31, solver="fgmres_jit", out=tmp_path)),
                     device="cpu")
    assert isinstance(sim.integrator, Ros2) and sim.integrator.gmres_restart == RESTART
    assert sim._chunk_len(0, 0.0) == 2  # the two steps run as one steps_device chunk
    q = sim.run()
    log = capsys.readouterr().out
    assert f"FGMRES(jit) chunk of 2: {sum(iters[:2])} total iterations" in log
    assert "Completed 2 steps" in log and "WARNING" not in log
    assert torch.equal(q, torch.as_tensor(states[1]))


@pytest.mark.parametrize("what", ["gcrot", "shallow_water"])
def test_unported_ros2_raises_naming_roadmap(tmp_path, what):
    if what == "gcrot":
        # gcrot is ported: one dcmip31 step with the JAX Ros2(gcrot)'s
        # matvec count, every Jacobian action one plain tangent here.
        want, jiters = _jax_run("gcrot", nsteps=1)
        states, iters, actions, plain = _port_run("gcrot", nsteps=1)
        assert iters == jiters
        assert _scaled(states[0], want[0]).max() < 1e-10
        assert actions == plain > iters[0]
        return
    # Ros2 on shallow water runs now (the SW Jacobian action): two case-6
    # steps of the INI through Simulation against the JAX Ros2 on the same
    # grid; and the perturbation form with topography (the mixed companion
    # of cases 5 and 10) builds: at its base its RHS is the absolute one.
    from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
    from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs_sw
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.testcases import williamson_case6
    from wxfactory_tpu_torch.models import make_rhs_shallow_water

    text = INI.format(equations="shallow_water", case=6, solver="fgmres_jit", out=tmp_path)
    text = text.replace("num_elements_vertical = 2\n", "").replace("ztop = 10000\n", "")
    sim = Simulation(Configuration(text), device="cpu")
    assert isinstance(sim.integrator, Ros2)
    got = sim.run().numpy()
    geom = make_cubed_sphere_2d(4, 2)
    ops, metric = make_dfr_operators(2), make_metric_2d(geom)
    jinteg = JRos2(j_make_rhs_sw(geom, ops, metric), tolerance=TOL, gmres_restart=RESTART, linear_solver="fgmres_jit")
    q = jnp.asarray(williamson_case6(geom))
    for _ in range(2):
        q = jinteg.step(q, DT)
    want = np.asarray(q)
    scale = np.abs(want).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
    assert float(np.abs((got - want) / scale).max()) < 1e-9
    from wxfactory_tpu.testcases import williamson_case5

    q5, topo = williamson_case5(geom, ops)
    q5 = torch.as_tensor(np.asarray(q5))
    pert = make_rhs_shallow_water(geom, ops, metric, device="cpu", topo=interop.sw_topography_fields(topo),
                                  perturbation_base=q5.numpy())
    absolute = interop.shallow_water_rhs(geom, ops, metric, topo=topo)(q5)
    assert pert.base.topography
    torch.testing.assert_close(pert(q5), absolute, rtol=0, atol=1e-12 * float(absolute.abs().max()))
