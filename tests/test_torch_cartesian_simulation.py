"""The port's ``Simulation`` on the Cartesian plane against the JAX
``Simulation`` on the same INI, on the CPU (the Gaussian bubble, case 2, at
5 x 7 elements, s = 4, float64; ``distribute = off`` on both):

* TVD-RK3 and Euler1, 10 steps of 0.02 s, within 1e-12 of scale;
* Ros2 + FGMRES with p-mg (3 levels) and with fv-mg (3 levels), 2 steps of
  1 s, within 1e-10 of scale with the same FGMRES counts. At the tolerance
  of ``tests/test_framework.py``'s p-mg config (1e-7) FGMRES stagnates at
  its 400-iteration budget in both packages with either family (each state
  then carries its own unconverged residual), so these runs solve to 1e-4,
  which both reach;
* TVD-RK3 with the Rayleigh sponge and the exponential filter;
* the port's checkpoint read back by the JAX package's ``load_state``
  (``panel_major`` False) equal to the JAX run's own, and a restart from
  it equal to the uninterrupted run; the CLI on the CPU;
* several ranks raise naming ROADMAP item 14.

The exponential integrators' runs: tests/test_torch_cartesian_exponential.py.

"Of scale": each variable's max of the JAX state, for the momenta at least
rho_max x 1 m/s: the bubble starts at rest, and the ulp by which XLA's and
torch's exp/log put the pressure (~1e5 Pa) apart reaches the winds through
the pressure gradient (3e-13 kg m^-2 s^-1 after 10 TVD-RK3 steps, winds of
~5e-3 m/s), so the winds' own max is no scale for it.
"""

import contextlib
import io
import os
import re

import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.output.state import load_state as j_load_state
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.simulation import Simulation, plan_distribution

torch.set_num_threads(1)

INI = """
[General]
equations = euler
[System]
distribute = off
[Grid]
grid_type = cartesian2d
x0 = 0
x1 = 1000
z0 = 0
z1 = 1500
[Test_case]
case_number = 2
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = kiops
tolerance = {tol}
verbose_solver = 1
starting_step = {start}
[Preconditioning]
preconditioner = {pre}
num_mg_levels = 3
pseudo_cfl = 3.0
[Spatial_discretization]
num_solpts = 4
num_elements_horizontal = 5
num_elements_vertical = 7
apply_sponge = {sponge}
sponge_tscale = 10
sponge_zscale = 500
expfilter_apply = {sponge}
expfilter_strength = 10
expfilter_order = 8
expfilter_cutoff = 0.25
[Output_options]
save_state_freq = {save}
output_dir = {out}
"""

KRYLOV = re.compile(r"(?:converged|convergence|stagnation) at iteration (\d+)")


def _ini(tmp_path, integrator, dt, nsteps, pre="none", tol="1e-7", sponge=0, save=0, start=0, tag="run"):
    return INI.format(dt=dt, t_end=dt * nsteps, integrator=integrator, pre=pre, tol=tol, sponge=sponge, save=save,
                      start=start, out=tmp_path / tag)


def _run_pair(text):
    """(port's final state, JAX's final state, port's log, JAX's log, each
    one's last step's solver statistics (iterations, substeps, rejected))."""
    logs, states, stats = [], [], []
    for make in (lambda: Simulation(Configuration(text), device="cpu"), lambda: JSimulation(JConfiguration(text))):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            sim = make()
            states.append(np.asarray(sim.run()))
        logs.append(log.getvalue())
        info = sim.integrator.solver_info
        stats.append(None if info is None else (info.total_num_it, info.num_substeps, info.num_rejected))
    return states[0], states[1], logs[0], logs[1], stats


def _scaled(got, want):
    scale = np.abs(want).reshape(4, -1).max(axis=1)
    scale[1:3] = np.maximum(scale[1:3], np.abs(want[0]).max() * 1.0)
    return float((np.abs(got - want) / scale.reshape(4, 1, 1, 1)).max())


@pytest.mark.parametrize("integrator", ["tvdrk3", "euler1"])
def test_explicit_runs_match_jax(tmp_path, integrator):
    got, want, log, _, _ = _run_pair(_ini(tmp_path, integrator, 0.02, 10))
    assert "Completed 10 steps" in log
    assert _scaled(got, want) < 1e-12


@pytest.mark.parametrize("pre", ["p-mg", "fv-mg"])
def test_ros2_multigrid_runs_match_jax(tmp_path, pre):
    got, want, log, jlog, _ = _run_pair(_ini(tmp_path, "ros2", 1.0, 2, pre=pre, tol="1e-4"))
    its = KRYLOV.findall(log)
    assert len(its) == 2 and its == KRYLOV.findall(jlog) and "stagnation" not in log
    assert _scaled(got, want) < 1e-10


def test_sponge_and_filter_run_matches_jax(tmp_path):
    got, want, _, _, _ = _run_pair(_ini(tmp_path, "tvdrk3", 0.02, 5, sponge=1))
    assert _scaled(got, want) < 1e-12


def test_checkpoint_restart_and_cli(tmp_path):
    from wxfactory_tpu_torch.__main__ import main

    text = _ini(tmp_path, "tvdrk3", 0.02, 4, save=2, tag="ckpt")
    full = Simulation(Configuration(text), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        q_full = full.run().numpy()
    jsim = JSimulation(JConfiguration(_ini(tmp_path, "tvdrk3", 0.02, 4, save=2, tag="jax")))
    with contextlib.redirect_stdout(io.StringIO()):
        jsim.run()
    # The port's checkpoint in the JAX package's format for this grid.
    path = full.output.state_file_name(4)
    state, config, version = j_load_state(path, panel_major=False)
    assert state.shape == (4, 7, 5, 16) and version == "1.0" and config.grid_type == "cartesian2d"
    np.testing.assert_array_equal(state, q_full)
    assert _scaled(state, j_load_state(jsim.output.state_file_name(4), panel_major=False)[0]) < 1e-12
    # A restart from step 2 equals the uninterrupted run.
    restart = Simulation(Configuration(_ini(tmp_path, "tvdrk3", 0.02, 4, save=2, start=2, tag="ckpt")), device="cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        np.testing.assert_array_equal(restart.run().numpy(), q_full)
    # The CLI, which drives the same Simulation.
    ini = tmp_path / "bubble.ini"
    ini.write_text(_ini(tmp_path, "tvdrk3", 0.02, 2, tag="cli"))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        assert main([str(ini), "--device", "cpu"]) == 0
    assert "Completed 2 steps" in log.getvalue()
    assert not os.path.exists(tmp_path / "cli" / "out.nc")


def test_several_ranks_raise(tmp_path):
    config = Configuration(_ini(tmp_path, "tvdrk3", 0.02, 2))
    assert plan_distribution(config, 1) is None
    with pytest.raises(NotImplementedError, match="item 14"):
        plan_distribution(config, 6)
