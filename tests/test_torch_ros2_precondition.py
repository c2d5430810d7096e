"""Ros2 with the p-mg preconditioner through the port's ``Simulation``
against the JAX ``Simulation`` on the same INI, on the CPU: Williamson
case 5 (nel = 4, s = 3, dt = 3600 s, two steps) and dcmip31 (2x2x3, dt =
30 s, one step: 12 iterations against 71 without it), both with the kiops
smoother and the host ``fgmres`` that
``linear_solver = auto`` takes with a preconditioner (the JAX package's
rule, integrators/rosenbrock.py:156-159 there): the same FGMRES iterations
at every step, states within the solver's tolerance, 1e-7 of each
variable's max (the kiops smoother's Krylov steps on A = I - dt/2 J at dt
= 3600 s carry the two Jacobian actions' 1e-15 rounding difference into the
preconditioned directions, so two converged solves differ by up to the
tolerance; 2e-8 measured for case 5).
"""

import contextlib
import io
import re

import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.precondition import Multigrid
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)


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

E3_INI = """
[General]
equations = euler
[System]
distribute = off
[Test_case]
case_number = 31
[Time_integration]
dt = 30
t_end = 30
time_integrator = ros2
tolerance = 1e-7
gmres_restart = 20
verbose_solver = 1
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 2
num_elements_vertical = 2
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Preconditioning]
preconditioner = {pre}
num_mg_levels = 2
mg_smoother = kiops
pseudo_cfl = 20
[Output_options]
output_dir = {out}
"""

ITERATIONS = re.compile(r"fgmres (?:convergence|stagnation) at iteration (\d+)")


@pytest.mark.parametrize("ini,steps", [(SW_INI, 2), (E3_INI, 1)], ids=["sw_case5", "dcmip31"])
def test_ros2_pmg_simulation_matches_jax(tmp_path, ini, steps):
    text = ini.format(pre="p-mg", out=tmp_path)
    with contextlib.redirect_stdout(io.StringIO()) as jlog:
        want = np.asarray(JSimulation(JConfiguration(text)).run())
    with contextlib.redirect_stdout(io.StringIO()) as log:
        sim = Simulation(Configuration(text), device="cpu")
        got = sim.run().numpy()
    assert isinstance(sim.integrator.preconditioner, Multigrid) and not sim.integrator._use_jit_solver()
    its, jits = ITERATIONS.findall(log.getvalue()), ITERATIONS.findall(jlog.getvalue())
    assert its == jits and len(its) == steps, (its, jits)
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (want.ndim - 1))
    assert float(np.abs((got - want) / scale).max()) < 1e-7
