"""The port's Simulation on 3D Euler against the JAX package's: the same
dcmip31 INI (3x2x2, s=2, tvdrk3, dt=2 s, 10 steps) runs through both
Simulation classes on the CPU; the final states agree to 1e-12 of each
variable's max, mass (sum of sqrt(g) w^3 rho, tests/test_euler3d.py:78-93)
drifts by less than 1e-12, and the JAX package's load_state reads the
port's checkpoint. Case 77 (rotating planet) takes the same path; the 3D
cases the port does not run yet raise."""

import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.output.state import load_state as j_load_state
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.models import Euler3DRHS
from wxfactory_tpu_torch.output import global_mass_3d
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)

INI = """
[General]
equations = euler
[System]
distribute = off
[Test_case]
case_number = {case}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 3
num_elements_vertical = 2
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = {save}
output_dir = {out}
"""


def _run_both(tmp_path, case, dt, steps):
    text = lambda out: INI.format(case=case, dt=dt, t_end=dt * steps, save=steps, out=out)
    jsim = JSimulation(JConfiguration(text(tmp_path / "jax")))
    want = np.asarray(jsim.run())
    sim = Simulation(Configuration(text(tmp_path / "torch")), device="cpu")
    got = sim.run().numpy()
    return jsim, want, sim, got


@pytest.mark.parametrize("case,dt", [(31, 2.0), (77, 1.0)], ids=["dcmip31", "acoustic77"])
def test_simulation_matches_jax(tmp_path, case, dt):
    jsim, want, sim, got = _run_both(tmp_path, case, dt, 10)
    assert isinstance(sim.rhs, Euler3DRHS)
    assert got.shape == want.shape == (5, 6, 2, 3, 3, 8)
    scale = np.abs(want).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    assert np.abs((got - want) / scale).max() < 1e-12
    m0 = global_mass_3d(sim.initial_q, sim.ops, sim.metric)
    assert abs(global_mass_3d(got, sim.ops, sim.metric) - m0) / abs(m0) < 1e-12

    path = sim.output.state_file_name(10)
    assert path.split("/")[-1] == jsim.output.state_file_name(10).split("/")[-1]  # same file naming
    state, config, version = j_load_state(path)  # the JAX reader takes the port's file
    assert config.equations == "euler" and config.case_number == case
    np.testing.assert_array_equal(state, got)


def test_float32_run_uses_the_balanced_offset(tmp_path):
    text = INI.format(case=31, dt=2.0, t_end=4.0, save=0, out=tmp_path).replace(
        "[System]", "[System]\nprecision = float32")
    sim = Simulation(Configuration(text), device="cpu")
    assert sim.rhs.bal is not None and sim.rhs.bal.dtype == torch.float32
    q = sim.run()
    assert q.dtype == torch.float32 and bool(torch.isfinite(q).all())


@pytest.mark.parametrize("case", [11, 12, 20, 21, 22])
def test_unported_3d_cases_raise(tmp_path, case):
    cfg = Configuration(INI.format(case=case, dt=2.0, t_end=20.0, save=0, out=tmp_path))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Simulation(cfg, device="cpu")
