"""The port's multi-process runs on the CPU (``torch.distributed`` over gloo,
one process a rank, launched as the reference's ``mpirun -n 6`` would be).

* Six ranks of the CLI (``python -m wxfactory_tpu_torch cfg.ini --device cpu
  --coordinator ... --num-processes 6 --process-id r``, the JAX CLI's flags)
  on Williamson case 6 (nel = 4, s = 3, float64, tvdrk3, ``distribute =
  shard_map``: one tile a rank): rank 0's checkpoints against the
  single-process port run to 1e-12 of scale and the JAX ``Simulation``'s
  checkpoint to 1e-11 (they agree to round-off), blockstats printed once;
  then a six-rank restart from the middle checkpoint reproduces the
  uninterrupted run's last checkpoint to 1e-12.
* Six ranks of the CLI on dcmip31 (4x3, s = 2, float64) against the
  single-process port run, 1e-12.
* The sharded checkpoint form (manifest and one shard a tile, written by
  every rank) reads back exactly at any process count.
* The ``distribute`` rules (the JAX package's simulation.py:274-380):
  ``gspmd`` raises (not ported), ``shard_map`` refuses an EPI run and an N
  that does not divide nel, and a multi-rank run that cannot take the tile
  step raises instead of running every rank redundantly.

Each launch kills its processes on every path and has its own timeout.
"""

import glob
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.output.state import load_state
from wxfactory_tpu_torch.parallel import TileMesh, is_tile_mesh
from wxfactory_tpu_torch.simulation import Simulation, plan_distribution

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mp_torch_worker.py")
RANKS = 6

SW_INI = """
[General]
equations = shallow_water
[System]
precision = float64
distribute = {dist}
[Test_case]
case_number = 6
[Time_integration]
dt = 30
t_end = 300
time_integrator = {integ}
{extra}
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = {nel}
[Grid]
grid_type = cubed_sphere
[Output_options]
save_state_freq = 5
stat_freq = 5
output_dir = {out}
"""

E3_INI = """
[General]
equations = euler
[System]
precision = float64
distribute = {dist}
[Test_case]
case_number = 31
[Time_integration]
dt = 1.0
t_end = 4.0
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 4
num_elements_vertical = 3
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = 4
output_dir = {out}
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(mode: str, arg: str, logs, timeout: float = 240.0):
    """Run ``RANKS`` workers; returns their exit codes and rank 0's output.
    Every process is killed on the way out, whatever happens."""
    port = str(_free_port())
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    procs, files = [], []
    try:
        for r in range(RANKS):
            fh = open(logs / f"{mode}_rank{r}.log", "w+")
            files.append(fh)
            procs.append(subprocess.Popen([sys.executable, WORKER, mode, port, str(RANKS), str(r), arg], env=env,
                                          cwd=REPO, stdout=fh, stderr=subprocess.STDOUT))
        codes = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in files:
            fh.close()
    outputs = [(logs / f"{mode}_rank{r}.log").read_text() for r in range(RANKS)]
    assert codes == [0] * RANKS, "\n".join(outputs)
    return outputs[0]


def _state(out_dir, step: int):
    files = glob.glob(os.path.join(out_dir, f"state_vector_*.{step:08d}.npy"))
    assert len(files) == 1, files
    return load_state(files[0])[0]


def _err(got, want):
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (want.ndim - 1))
    return float(np.abs((got - want) / scale).max())


def _run_single(text: str):
    sim = Simulation(Configuration(text), device="cpu")
    sim.run()
    return sim


def test_six_rank_cli_matches_single_jax_and_restarts(tmp_path):
    out = tmp_path / "ranks"
    cfg = tmp_path / "sw.ini"
    cfg.write_text(SW_INI.format(dist="shard_map", integ="tvdrk3", extra="", nel=4, out=out))
    log = _launch("cli", str(cfg), tmp_path)
    assert "halo exchange over gloo" in log and "x 6 ranks" in log
    assert log.count("normalized error for mass") == 3  # steps 0, 5, 10: blockstats on rank 0 only

    single = tmp_path / "single"
    _run_single(SW_INI.format(dist="off", integ="tvdrk3", extra="", nel=4, out=single))
    for step in (5, 10):
        assert _err(_state(out, step), _state(single, step)) < 1e-12

    from wxfactory_tpu.config import Configuration as JConfiguration
    from wxfactory_tpu.simulation import Simulation as JSimulation

    jax_out = tmp_path / "jax"
    JSimulation(JConfiguration(SW_INI.format(dist="off", integ="tvdrk3", extra="", nel=4, out=jax_out))).run()
    assert _err(_state(out, 10), _state(jax_out, 10)) < 1e-11

    # Restart six ranks from the middle checkpoint.
    full = _state(out, 10)
    for f in glob.glob(str(out / "state_vector_*.00000010.npy")):
        os.unlink(f)
    cfg.write_text(SW_INI.format(dist="shard_map", integ="tvdrk3", extra="starting_step = 5", nel=4, out=out))
    log = _launch("cli", str(cfg), tmp_path)
    assert "Starting simulation from step 5" in log
    assert _err(_state(out, 10), full) < 1e-12


def test_six_rank_cli_euler3d_matches_single(tmp_path):
    cfg = tmp_path / "e3.ini"
    cfg.write_text(E3_INI.format(dist="auto", out=tmp_path / "ranks"))
    log = _launch("cli", str(cfg), tmp_path)
    assert "Completed 4 steps" in log
    _run_single(E3_INI.format(dist="off", out=tmp_path / "single"))
    assert _err(_state(tmp_path / "ranks", 4), _state(tmp_path / "single", 4)) < 1e-12


def test_sharded_checkpoint_round_trip(tmp_path):
    _launch("sharded", str(tmp_path), tmp_path)
    assert len(glob.glob(str(tmp_path / "*.shard*_*.npy"))) == 6


def test_distribute_rules(tmp_path):
    cfg = lambda **kw: Configuration(SW_INI.format(**dict(dict(dist="auto", integ="tvdrk3", extra="", nel=4,
                                                              out=tmp_path), **kw)))
    with pytest.raises(NotImplementedError, match="gspmd"):
        Simulation(cfg(dist="gspmd"), device="cpu")
    epi = dict(integ="epi2", extra="exponential_solver = kiops")
    with pytest.raises(ValueError, match="shard_map"):
        plan_distribution(cfg(dist="shard_map", **epi), 24)
    with pytest.raises(ValueError, match="shard_map"):
        plan_distribution(cfg(dist="shard_map", nel=5), 24)  # N = 2 does not divide nel
    with pytest.raises(ValueError, match="shard_map"):
        plan_distribution(cfg(dist="shard_map"), 1)  # one process has no 6N^2 mesh
    with pytest.raises(NotImplementedError, match="item 14"):
        plan_distribution(cfg(dist="auto", **epi), 6)  # would run every rank redundantly
    with pytest.raises(NotImplementedError, match="item 14"):
        plan_distribution(cfg(dist="off"), 6)
    assert plan_distribution(cfg(dist="auto"), 1) is None
    assert plan_distribution(cfg(dist="auto", **epi), 1) is None
    assert plan_distribution(cfg(dist="auto"), 6) == 1
    assert plan_distribution(cfg(dist="shard_map"), 24) == 2
    assert is_tile_mesh(TileMesh(2, 3, 24)) and TileMesh(2, 3, 24).owned() == [3]
    with pytest.raises(ValueError, match="divide"):
        TileMesh(2, 0, 5)
