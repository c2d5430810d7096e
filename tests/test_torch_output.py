"""The port's output layer against the JAX package's, on the CPU: NetCDF
field files (``output/netcdf.py``, the scipy backend here), the
solver-stats SQLite database (``output/solver_stats.py``) with its RHS
timing rows (``output/rhs_timing.py``) and the runtime file.

* The writers of both packages on the same state (the four tests of
  tests/test_output_netcdf.py): shallow water (case 6), shallow water with
  case 5's topography (h written as h + hsurf), 3D Euler (dcmip31) and the
  output manager's routing of Euler fields: the same variables,
  dimensions, units and shapes, values within 1e-12 (RV and PV within
  1e-9) of each variable's max.
* ``SolverStatsOutput`` of both packages on the same configuration: the
  same schema and the same run_param row (deduplicated by the same hash on
  a second registration).
* A case-5 EPI3 + pmex ``Simulation`` with every output knob on
  (output_freq, store_solver_stats, rhs_timing_freq, store_total_time) in
  both packages leaves the same files: the fields of every write within
  1e-9, the same results_data rows but for the times, the same rhs_timing
  stages at the same steps, and a runtime line of the same form.
"""

import contextlib
import io
import os
import sqlite3

import numpy as np
from scipy.io import netcdf_file

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.geometry import make_cubed_sphere_2d as j_geom
from wxfactory_tpu.geometry import make_metric_2d as j_metric
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_ops
from wxfactory_tpu.output.manager import OutputManager as JOutputManager
from wxfactory_tpu.output.netcdf import make_writer as j_make_writer
from wxfactory_tpu.output.solver_stats import SolverStatsOutput as JSolverStats
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.testcases import williamson_case5 as j_case5
from wxfactory_tpu.testcases import williamson_case6 as j_case6
from wxfactory_tpu.testcases.dcmip import dcmip_gravity_wave
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.geometry import make_cubed_sphere_2d, make_cubed_sphere_3d, make_metric_2d, make_metric_3d
from wxfactory_tpu_torch.ops.dfr import make_dfr_operators
from wxfactory_tpu_torch.output import SolverStatsOutput
from wxfactory_tpu_torch.output.manager import OutputManager
from wxfactory_tpu_torch.output.netcdf import make_writer
from wxfactory_tpu_torch.parallel import CubedSphereTopology
from wxfactory_tpu_torch.simulation import Simulation
from wxfactory_tpu_torch.testcases import williamson_case5

NEL, S = 4, 3


def _read(path):
    with netcdf_file(str(path), "r", mmap=False) as f:
        return ({k: np.array(v[:]) for k, v in f.variables.items()},
                {k: dict(v._attributes) for k, v in f.variables.items()},
                {k: v for k, v in f.dimensions.items()})


def _assert_same_files(got_path, want_path, loose=(), tol=1e-12, loose_tol=1e-9):
    got, got_attrs, got_dims = _read(got_path)
    want, want_attrs, want_dims = _read(want_path)
    assert set(got) == set(want) and got_attrs == want_attrs and got_dims == want_dims
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()), 1e-300)
        limit = loose_tol if name in loose else tol
        assert float(np.abs(g - w).max()) <= limit * scale, name


def _sw_pair(nel, s):
    return (j_geom(nel, s), j_ops(s)), (make_cubed_sphere_2d(nel, s), make_dfr_operators(s))


def test_sw_netcdf_matches_jax_writer(tmp_path):
    (jg, jo), (g, o) = _sw_pair(NEL, S)
    q = np.asarray(j_case6(jg))
    jw = j_make_writer(str(tmp_path / "jax.nc"), jg, j_metric(jg), jo, "shallow_water")
    w = make_writer(str(tmp_path / "port.nc"), g, make_metric_2d(g), o, "shallow_water")
    for writer in (jw, w):
        writer.write_sw(0.0, q)
        writer.write_sw(1800.0, q * 1.01)
        writer.close()
    _assert_same_files(tmp_path / "port.nc", tmp_path / "jax.nc", loose=("RV", "PV"))
    got, attrs, _ = _read(tmp_path / "port.nc")
    assert got["h"].shape == (2, 6, NEL * S, NEL * S) and attrs["time"]["units"] == b"seconds since simulation start"


def test_sw_topography_netcdf_matches_jax_writer(tmp_path):
    (jg, jo), (g, o) = _sw_pair(NEL, S)
    jq, jtopo = j_case5(jg, jo)
    q, topo = williamson_case5(g, o)
    np.testing.assert_allclose(q, np.asarray(jq), rtol=1e-13, atol=0)
    jw = j_make_writer(str(tmp_path / "jax.nc"), jg, j_metric(jg), jo, "shallow_water", topo=jtopo)
    w = make_writer(str(tmp_path / "port.nc"), g, make_metric_2d(g), o, "shallow_water", topo=topo)
    jw.write_sw(0.0, np.asarray(jq))
    w.write_sw(0.0, np.asarray(jq))
    jw.close()
    w.close()
    _assert_same_files(tmp_path / "port.nc", tmp_path / "jax.nc", loose=("RV", "PV"))
    got, _, _ = _read(tmp_path / "port.nc")
    np.testing.assert_allclose(got["h"][0], g.to_single_block(np.asarray(jq)[0] + topo.hsurf), rtol=1e-12)


def _euler_pair():
    from conftest import cs3d_setup

    nel_h, nel_v, s, ztop = 4, 2, 2, 10000.0
    jg, jo, _, jm = cs3d_setup(nel_h, nel_v, s, ztop)
    g = make_cubed_sphere_3d(nel_h, nel_v, s, ztop, planet_scaling_factor=125.0, planet_is_rotating=False)
    o = make_dfr_operators(s, three_d=True)
    m = make_metric_3d(g, o, CubedSphereTopology(g))
    return (jg, jo, jm), (g, o, m), np.asarray(dcmip_gravity_wave(jg))


def test_euler_netcdf_matches_jax_writer(tmp_path):
    (jg, jo, jm), (g, o, m), q = _euler_pair()
    jw = j_make_writer(str(tmp_path / "jax.nc"), jg, jm, jo, "euler")
    w = make_writer(str(tmp_path / "port.nc"), g, m, o, "euler")
    for writer in (jw, w):
        writer.write_euler(0.0, q)
        writer.close()
    _assert_same_files(tmp_path / "port.nc", tmp_path / "jax.nc", loose=("U", "V", "W"))
    got, _, _ = _read(tmp_path / "port.nc")
    assert got["rho"].shape == (1, 2 * 2, 6, 4 * 2, 4 * 2)


E3_INI = """
[General]
equations = euler
[Grid]
grid_type = cubed_sphere
ztop = 10000.0
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 4
num_elements_vertical = 2
[Test_case]
case_number = 31
[Time_integration]
dt = 30.0
t_end = 60.0
time_integrator = tvdrk3
[Output_options]
output_freq = 1
output_dir = {out}
base_output_file = e3
output_format = netcdf
"""


def test_manager_routes_euler_output_as_jax(tmp_path):
    import torch

    (jg, jo, jm), (g, o, m), q = _euler_pair()
    jmgr = JOutputManager(JConfiguration(E3_INI.format(out=tmp_path / "jax")), jg, jo, jm)
    jmgr.step(q, 0, 0.0)
    jmgr.finalize()
    mgr = OutputManager(Configuration(E3_INI.format(out=tmp_path / "port")), g, o, m)
    mgr.step(torch.as_tensor(q), 0, 0.0)
    mgr.step(torch.as_tensor(q), 1, 30.0)
    mgr.finalize()
    assert mgr.num_writes == 2
    got, _, _ = _read(tmp_path / "port" / "e3.nc")
    want, _, _ = _read(tmp_path / "jax" / "e3.nc")
    assert got["theta"].shape[0] == 2 and want["theta"].shape[0] == 1
    np.testing.assert_allclose(got["theta"][0], want["theta"][0], rtol=1e-12)
    np.testing.assert_allclose(got["time"], [0.0, 30.0])


def _tables(path):
    db = sqlite3.connect(str(path))
    try:
        schema = dict(db.execute("SELECT name, sql FROM sqlite_master WHERE type = 'table'").fetchall())
        cols = "param_hash, equations, case_number, grid_type, num_solpts, num_elements_horizontal, " \
               "num_elements_vertical, dt, time_integrator, exponential_solver, tolerance, preconditioner, " \
               "jacobian_method"
        params = db.execute(f"SELECT run_id, {cols} FROM run_param ORDER BY run_id").fetchall()
        results = db.execute("SELECT run_id, step_id, num_iterations, num_substeps, num_rejected, error_estimate, "
                             "converged FROM results_data ORDER BY rowid").fetchall()
        solve = db.execute("SELECT solve_time FROM results_data").fetchall()
        timing = db.execute("SELECT run_id, step_id, stage, elapsed FROM rhs_timing ORDER BY rowid").fetchall()
        return schema, params, results, solve, timing
    finally:
        db.close()


def test_solver_stats_schema_and_rows_match_jax(tmp_path):
    text = E3_INI.format(out=tmp_path).replace("time_integrator = tvdrk3", "time_integrator = epi2")
    for name, cls, cfg in (("jax.db", JSolverStats, JConfiguration(text)), ("port.db", SolverStatsOutput,
                                                                             Configuration(text))):
        for _ in range(2):  # the second registration finds the first run's row
            out = cls(cfg, db_path=str(tmp_path / name))
            assert out.run_id == 1
            out.write_output(3, num_iterations=17, solve_time=0.5, num_substeps=2, num_rejected=1,
                             error_estimate=1e-8)
            out.write_rhs_timing(3, ["full_rhs(fused)", "extrapolation"], [1e-3, 2e-4])
            out.close()
    got, want = _tables(tmp_path / "port.db"), _tables(tmp_path / "jax.db")
    assert got[0] == want[0]  # the same tables, column for column
    assert got[1] == want[1] and got[2] == want[2] and got[4] == want[4]


SW_INI = """
[General]
equations = shallow_water
[System]
distribute = off
[Test_case]
case_number = 5
[Time_integration]
dt = 1800
t_end = 5400
time_integrator = epi3
exponential_solver = pmex
tolerance = 1e-7
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Grid]
grid_type = cubed_sphere
[Output_options]
output_freq = 1
store_solver_stats = 1
rhs_timing_freq = 2
store_total_time = 1
base_output_file = case5
output_dir = {out}
"""


def test_simulation_outputs_match_jax(tmp_path):
    with contextlib.redirect_stdout(io.StringIO()):
        JSimulation(JConfiguration(SW_INI.format(out=tmp_path / "jax"))).run()
    with contextlib.redirect_stdout(io.StringIO()):
        sim = Simulation(Configuration(SW_INI.format(out=tmp_path / "port")), device="cpu")
        q = sim.run().numpy()
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    # Fields: the initial state and three steps.
    _assert_same_files(pdir / "case5.nc", jdir / "case5.nc", tol=1e-9, loose_tol=1e-7)
    got, _, _ = _read(pdir / "case5.nc")
    assert got["h"].shape[0] == 4
    np.testing.assert_allclose(got["h"][-1], sim.geom.to_single_block(q[0] + sim.topo.hsurf), rtol=1e-12)
    # The database: schema, run_param, results_data but for the times,
    # rhs_timing stages at the same steps.
    schema, params, results, solve, timing = _tables(pdir / "solver_stats.db")
    jschema, jparams, jresults, _, jtiming = _tables(jdir / "solver_stats.db")
    # Steps 2 and 3: the first EPI3 step's bootstrap reports through its
    # Epi2 substeps, not the step's solver_info, in both packages.
    assert schema == jschema and params == jparams and [r[1] for r in results] == [2, 3]
    # The step's Krylov error estimate (a residual norm near the tolerance)
    # agrees to the states' rounding; every other column exactly.
    drop = lambda rows: [r[:5] + r[6:] for r in rows]
    assert drop(results) == drop(jresults)
    np.testing.assert_allclose([r[5] for r in results], [r[5] for r in jresults], rtol=1e-6, atol=0)
    assert all(t[0] > 0.0 for t in solve)
    assert [r[:3] for r in timing] == [r[:3] for r in jtiming] and len(timing) == 4
    assert all(r[3] > 0.0 for r in timing)
    # The runtime line: solver, nel, integrator, case, then the seconds.
    line, = open(pdir / "runtime_epi3.txt").read().splitlines()
    jline, = open(jdir / "runtime_epi3.txt").read().splitlines()
    assert line.split()[:4] == jline.split()[:4] == ["pmex", "4", "epi3", "5"] and float(line.split()[4]) > 0.0
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
