"""The port's Simulation against the JAX package's: the same INI (Williamson
case 6, nel=6, s=3, tvdrk3, dt=30, 5 steps) runs through both Simulation
classes on the CPU; both checkpoints are read with the JAX package's
load_state and agree to 1e-11 of each variable's max. Also: the port never
imports JAX, and a CUDA request on a machine without CUDA raises instead of
running on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.output.state import load_state as j_load_state
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.output.state import load_state
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

INI = """
[General]
equations = shallow_water
[System]
distribute = off
[Test_case]
case_number = 6
[Time_integration]
dt = 30
t_end = 150
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 6
[Grid]
grid_type = cubed_sphere
[Output_options]
save_state_freq = 5
stat_freq = 5
output_dir = {out}
"""


def test_simulation_checkpoint_matches_jax(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jsim = JSimulation(JConfiguration(INI.format(out=jdir)))
    jsim.run()
    sim = Simulation(Configuration(INI.format(out=tdir)), device="cpu")
    sim.run()

    jpath = jsim.output.state_file_name(5)
    path = sim.output.state_file_name(5)
    assert os.path.basename(path) == os.path.basename(jpath)  # same file naming
    want, _, jversion = j_load_state(jpath)
    got, config, version = j_load_state(path)  # the JAX reader takes the port's file
    assert version == jversion and config.case_number == 6
    assert got.shape == want.shape == (3, 6, 6, 6, 9)
    scale = np.abs(want).max(axis=(1, 2, 3, 4), keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-11)

    mine, _, _ = load_state(path)
    np.testing.assert_array_equal(mine, got)
    assert abs(sim.output.last_drift[0]) < 1e-12  # mass is conserved to round-off


def test_restart_from_checkpoint_continues_the_run(tmp_path):
    """starting_step resumes from the saved state: 5 + 5 steps equal 10."""
    text = INI.format(out=tmp_path).replace("t_end = 150", "t_end = 300")
    full = Simulation(Configuration(text), device="cpu").run()
    resumed = Simulation(Configuration(text.replace("[Time_integration]", "[Time_integration]\nstarting_step = 5")),
                         device="cpu")
    assert resumed.starting_step == 5
    torch.testing.assert_close(resumed.run(), full, rtol=1e-13, atol=0)


def test_port_does_not_import_jax():
    code = "import sys, wxfactory_tpu_torch.simulation, wxfactory_tpu_torch.interop; " \
           "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'wxfactory_tpu')))"
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_cuda_request_without_cuda_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the check is for machines without it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(Configuration(INI.format(out=tmp_path)), device="cuda")


@pytest.mark.parametrize(
    "line,replacement,raises",
    [
        # Every integrator of the JAX package's Simulation runs
        # (tests/test_torch_srerk.py, test_torch_implicit.py); imex2 needs a
        # partitioned RHS that neither package's models provide, and raises
        # the JAX package's ValueError.
        ("time_integrator = tvdrk3", "time_integrator = imex2", ValueError),
        # filter_apply has no effect in the JAX package either (its
        # make_apply_filters reads expfilter_apply only): no filter, no error.
        ("[Spatial_discretization]\n", "[Spatial_discretization]\nfilter_apply = 1\n", None),
        # One process has no 6N^2 tile mesh: distribute = shard_map there is a
        # configuration error (ValueError, as in the JAX package;
        # tests/test_torch_distributed.py); the GSPMD analogue is unported.
        ("distribute = off", "distribute = gspmd", NotImplementedError),
    ],
    ids=["integrator", "filter", "distribution"],
)
def test_unported_configurations_raise(tmp_path, line, replacement, raises):
    cfg = Configuration(INI.format(out=tmp_path).replace(line, replacement))
    if raises is None:
        assert Simulation(cfg, device="cpu").apply_filters is None
        return
    with pytest.raises(raises):
        Simulation(cfg, device="cpu")
