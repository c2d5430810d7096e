"""The port's device-resident exponential step (``Epi`` with
``exponential_solver="kiops_jit"``, with and without the float32
perturbation-form companion of ``mixed_precision_krylov``) against the JAX
package's, dcmip31 at dt = 30 s, tolerance 1e-7, mmin 16, mmax 64, float64.
On the CPU the port's Jacobian actions are the plain tangents
(``torch.func.jvp``).

* float64 ``kiops_jit``, 2 EPI2 steps on 4x2x2, s=2: the same Krylov
  iterations, substeps and rejections at both steps as the JAX
  ``Epi(kiops_jit)``, states within 1e-9 of each variable's max.
* Mixed precision, 2 steps: within (1e-4, 5e-3) of the port's own float64
  ``kiops_jit`` trajectory at each step, scaled by the state's max (the
  bounds and scale of tests/test_euler3d.py:140-174); and on 4x2x4, s=4,
  within 2e-5 of each variable's max of the JAX ``Epi(kiops_jit,
  rhs32=...)`` whose companion is the XLA perturbation form — on the CPU
  that takes ``jax.jvp`` of the absolute float32 operator, where the port
  (like the JAX package on a TPU) applies the perturbation tangent. The
  bound and the shape are those of tests/test_euler3d.py:260-290, where the
  JAX package holds its own two companions to 2e-5; at 4x2x2, s=2 those
  two differ by 2.6e-4, and the port sits as far from each.
* ``Simulation``/CLI with ``device_step_chunk = 4`` against 1 (mixed,
  checkpoints every 3 steps): the chunks stop at the checkpoints
  (``_chunk_len``, as tests/test_framework.py:343-375), the trajectories
  agree to 1e-9, the checkpoints land on steps 3 and 6, and no warning says
  the knob has no effect.
* The ``mixed_precision_krylov`` warnings of the JAX package's
  simulation.py:182-201.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.integrators import Epi as JEpi
from wxfactory_tpu.models import make_rhs_euler_cubesphere
from wxfactory_tpu.testcases import dcmip_gravity_wave
from wxfactory_tpu_torch import __main__ as cli
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.integrators import Epi
from wxfactory_tpu_torch.output.state import load_state
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)

DT = 30.0


def _setup(nel_h, nel_v, s):
    from conftest import cs3d_setup

    geom, ops, topo, metric = cs3d_setup(nel_h, nel_v, s)
    return geom, ops, topo, metric, dcmip_gravity_wave(geom)


def _scaled_err(got, want):
    scale = np.abs(want).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    return float(np.abs((got - want) / scale).max())


def _stats(integ):
    info = integ.solver_info
    return info.total_num_it, info.num_substeps, info.num_rejected


def _port_steps(geom, ops, metric, q0, steps, mixed):
    rhs32 = interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32, perturbation_base=q0) if mixed else None
    integ = Epi(interop.euler3d_rhs(geom, ops, metric), order=2, exponential_solver="kiops_jit", tolerance=1e-7,
                rhs32=rhs32)
    q, states, stats = interop.to_tensor(q0), [], []
    for _ in range(steps):
        q = integ.step(q, DT)
        states.append(q.numpy())
        stats.append(_stats(integ))
    return states, stats, integ


@pytest.fixture(scope="module")
def f64_422():
    """The port's float64 kiops_jit trajectory on 4x2x2 (2 steps)."""
    geom, ops, topo, metric, q0 = _setup(4, 2, 2)
    states, stats, integ = _port_steps(geom, ops, metric, q0, 2, mixed=False)
    return states, stats, integ.krylov_size


def test_f64_kiops_jit_matches_jax(f64_422):
    geom, ops, topo, metric, q0 = _setup(4, 2, 2)
    jinteg = JEpi(make_rhs_euler_cubesphere(geom, ops, metric, topo), order=2, exponential_solver="kiops_jit",
                  tolerance=1e-7)
    q, want_stats = jnp.asarray(q0), []
    for _ in range(2):
        q = jinteg.step(q, DT)
        want_stats.append(_stats(jinteg))
    states, stats, krylov_size = f64_422
    assert stats == want_stats
    assert krylov_size == jinteg.krylov_size  # the warm start
    assert _scaled_err(states[-1], np.asarray(q)) < 1e-9


def test_mixed_stays_within_bounds_of_f64_trajectory(f64_422):
    geom, ops, topo, metric, q0 = _setup(4, 2, 2)
    states, stats, integ = _port_steps(geom, ops, metric, q0, 2, mixed=True)
    assert stats[0][0] < f64_422[1][0][0]  # fewer iterations with the full CGS2 basis
    for got, want, tol in zip(states, f64_422[0], (1e-4, 5e-3)):
        assert np.abs(got - want).max() / np.abs(want).max() < tol


def test_mixed_matches_jax_companion():
    geom, ops, topo, metric, q0 = _setup(4, 2, 4)
    rhs32 = make_rhs_euler_cubesphere(geom, ops, metric, topo, dtype=jnp.float32, interior="xla",
                                      perturbation_base=q0)
    jinteg = JEpi(make_rhs_euler_cubesphere(geom, ops, metric, topo), order=2, exponential_solver="kiops_jit",
                  tolerance=1e-7, rhs32=rhs32)
    q = jnp.asarray(q0)
    for _ in range(2):
        q = jinteg.step(q, DT)
    states, _, _ = _port_steps(geom, ops, metric, q0, 2, mixed=True)
    assert _scaled_err(states[-1], np.asarray(q)) < 2e-5


INI = """
[General]
equations = euler
[System]
distribute = off
precision = {precision}
[Test_case]
case_number = 31
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = epi2
exponential_solver = {solver}
tolerance = 1e-7
mixed_precision_krylov = 1
device_step_chunk = {chunk}
verbose_solver = 1
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 4
num_elements_vertical = 2
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = 3
output_dir = {out}
"""


def _ini(out, chunk, solver="kiops_jit", precision="float64", dt=10.0, steps=6):
    return INI.format(dt=dt, t_end=dt * steps, chunk=chunk, out=out, solver=solver, precision=precision)


def test_device_step_chunk_matches_single_steps(tmp_path, capsys):
    finals = {}
    for chunk in (1, 4):
        ini = tmp_path / f"chunk{chunk}.ini"
        ini.write_text(_ini(tmp_path / f"out{chunk}", chunk))
        sim = Simulation(str(ini), device="cpu")
        if chunk == 4:
            # The checkpoint calendar (every 3 steps) caps the chunks at 3.
            assert (sim._chunk_len(0, 0.0), sim._chunk_len(3, 30.0), sim._chunk_len(5, 50.0)) == (3, 3, 1)
        assert cli.main([str(ini), "--device", "cpu"]) == 0
        log = capsys.readouterr().out
        assert "no effect" not in log and "cannot consume" not in log
        assert log.count("kiops_jit converged at iteration") == 6
        for step in (3, 6):
            finals[(chunk, step)], config, _ = load_state(sim.output.state_file_name(step))
        for step in (1, 2, 4, 5):
            assert not Path(sim.output.state_file_name(step)).exists()
    assert config.device_step_chunk == 4 and config.mixed_precision_krylov
    for step in (3, 6):
        assert _scaled_err(finals[(4, step)], finals[(1, step)]) < 1e-9


def test_chunked_simulation_uses_the_companion(tmp_path):
    sim = Simulation(Configuration(_ini(tmp_path, 4)), device="cpu")
    assert sim.rhs32 is not None and sim.rhs32.dtype == torch.float32
    assert sim.integrator.rhs32 is sim.rhs32
    assert torch.equal(sim.rhs32.base_state, sim.initial_q.to(torch.float32))
    integ = sim.integrator
    q = integ.steps_device(sim.initial_q, 5.0, 2)
    assert integ.num_completed_steps == 2 and integ.solver_info.total_num_it > 0
    assert bool(torch.isfinite(q).all())


@pytest.mark.parametrize("solver,precision,warning", [
    ("kiops", "float64", "cannot consume it"),
    ("kiops_jit", "float32", "no f32 companion RHS"),
    ("kiops_jit", "float64", None),
], ids=["kiops", "float32-state", "kiops_jit"])
def test_mixed_precision_warnings(tmp_path, capsys, solver, precision, warning):
    sim = Simulation(Configuration(_ini(tmp_path, 1, solver, precision)), device="cpu")
    out = capsys.readouterr().out
    if warning is None:
        assert "WARNING: mixed_precision_krylov" not in out
        assert sim.rhs32 is not None
    else:
        assert "WARNING: mixed_precision_krylov is set but" in out and warning in out
