"""DCMIP 11 and 12 (tracer transport under prescribed winds) in the port
against the JAX package, on the CPU:

* the initial states (9 and 6 rows) and the winds at t = 0, dt and tau/3,
  the port's ``PrescribedWinds`` on the CPU device against the JAX numpy
  wind functions, within 1e-14 of each component's scale; the wind
  overwrite changes rows 1-3 only;
* the plain advection operator (``euler3d_advection_plain``) against the
  JAX ``make_rhs_euler_cubesphere(advection_only=True)`` XLA RHS at 3x3x2,
  s = 2 and 4x4x3, s = 3: the RHS, the stage with x and its emitted traces
  within 1e-12 of each tracer's flux-divergence scale in float64; float32
  against the float64 truth within 1e-5 of that scale or twice the JAX
  float32 RHS's distance; rows 0-4 exactly 0 and each tracer's mass
  integral of the RHS zero to 1e-14 of its absolute integral;
* the port's ``Simulation(device="cpu")`` against the JAX ``Simulation``,
  cases 11 and 12, TVD-RK3 and Euler1, 3 steps (the wind overwrite
  included; dt 18.75 s and 0.5859375 s, inside the explicit limit that the
  overwrite's vertical wind sets: the JAX package writes w in m/s into the
  contravariant slot, whose unit is the reference element, so |w| of up to
  0.015 and 0.33 a second there bounds dt near 25 s and 1.2 s): within
  1e-12 of each variable's max, the momenta
  rho * the winds at t_end, the tracers' mass conserved; a restart from
  the port's checkpoint equal to the uninterrupted run; the NetCDF file's
  variables those of the JAX run (neither writes tracers);
* the refusals, each naming its ROADMAP item: 11/12 over 6 ranks (item
  14; ``shard_map`` the JAX package's ValueError), a tracer count the
  kernel does not take (2); the implicit, exponential and Rosenbrock
  integrators run these cases (tests/test_torch_dcmip_advection_tangent.py,
  which also holds the multigrid's refusal, item 19);
* the five-row halo glue bit for bit what it was before tracer rows."""

import numpy as np
import pytest
import torch
from conftest import cs3d_setup
from scipy.io import netcdf_file

import jax
import jax.numpy as jnp
from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.models.euler_cubesphere import build_euler3d_constants, make_rhs_euler_cubesphere
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.testcases import dcmip as jdcmip
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.geometry import make_cubed_sphere_3d
from wxfactory_tpu_torch.kernels.check import mass_weights
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.output import global_mass_3d
from wxfactory_tpu_torch.simulation import Simulation, plan_distribution
from wxfactory_tpu_torch.testcases import PrescribedWinds, initial_state_3d

torch.set_num_threads(1)

ZTOP = 12000.0
DT = 300.0
# The Simulation paths' dt a case (see the module docstring).
SIM_DT = {11: 18.75, 12: 0.5859375}
J_INIT = {11: jdcmip.dcmip_advection_deformation, 12: jdcmip.dcmip_advection_hadley}
J_WINDS = {11: jdcmip.dcmip_T11_update_winds, 12: jdcmip.dcmip_T12_update_winds}


def _setup(nel_h, nel_v, s):
    """The JAX package's (geom, ops, topology, metric) on DCMIP 11/12's planet (read-only cache)."""
    return cs3d_setup(nel_h, nel_v, s, ztop=ZTOP, scale=1.0, rotating=True)


def _jax_rhs(geom, ops, topo, metric, **kw):
    """The JAX advection-only XLA RHS, jitted (one compile, not one an op)."""
    return jax.jit(make_rhs_euler_cubesphere(geom, ops, metric, topo, advection_only=True, **kw))


def _row_scale(a):
    return np.abs(a).reshape(a.shape[0], -1).max(axis=1)


@pytest.mark.parametrize("case", [11, 12])
def test_initial_state_and_winds_match_jax(case):
    jgeom = _setup(3, 2, 2)[0]
    geom = make_cubed_sphere_3d(3, 2, 2, ZTOP, planet_scaling_factor=1.0, planet_is_rotating=True)
    want = J_INIT[case](jgeom)
    got, geom_out, metric, damping = initial_state_3d(geom, case)
    assert geom_out is geom and metric is None and damping is None
    assert got.shape == want.shape == ((9 if case == 11 else 6), 6, 2, 3, 3, 8)
    scale = np.maximum(_row_scale(want), 1e-300).reshape(-1, 1, 1, 1, 1, 1)
    assert np.abs((got - want) / scale).max() <= 1e-14

    winds = PrescribedWinds(geom, case, device="cpu")
    for t in (0.0, DT, winds.tau / 3.0):
        want_w = np.stack(J_WINDS[case](jgeom, t))
        got_w = winds(t).numpy()
        assert np.abs(got_w - want_w).max(axis=(1, 2, 3, 4, 5)).max() <= 1e-14 * _row_scale(want_w).max()
        assert (np.abs(got_w - want_w).reshape(3, -1).max(axis=1) <= 1e-14 * _row_scale(want_w)).all()
    q = torch.as_tensor(got)
    out = winds.overwrite(q, DT)
    assert out is not q and torch.equal(out[0], q[0]) and torch.equal(out[4:], q[4:])
    torch.testing.assert_close(out[1:4], q[0] * winds(DT), rtol=0, atol=0)


def _np_edge_traces(q, ee, ss):
    """The JAX side's panel-edge traces (S, N, W, E) of a state: the log-space
    extrapolation of _euler3d_rhs_core with the JAX constants' EE."""
    lg = np.concatenate([np.log(q[0:1]), q[1:4], np.log(q[4:5]), q[5:]])
    ex = lambda t: np.concatenate([np.exp(t[0:1]), t[1:4], np.exp(t[4:5]), t[5:]])
    south = ex(lg[:, :, :, 0] @ ee[:, 2 * ss : 3 * ss])
    north = ex(lg[:, :, :, -1] @ ee[:, 3 * ss : 4 * ss])
    west = ex(lg[:, :, :, :, 0] @ ee[:, :ss])
    east = ex(lg[:, :, :, :, -1] @ ee[:, ss : 2 * ss])
    return np.stack([south, north, west, east], axis=1)


def _inputs(case, nel_h, nel_v, s, seed=3):
    """Two noisy states of the case (1e-3 relative on every row, 0.1 rho
    N(0,1) on each tracer) on the JAX setup."""
    jgeom = _setup(nel_h, nel_v, s)[0]
    q = J_INIT[case](jgeom)
    rng = np.random.default_rng(seed)

    def noisy():
        out = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
        out[5:] += 0.1 * q[0] * rng.standard_normal(q[5:].shape)
        return out

    return noisy(), noisy()


def _term_scale(y, con):
    """Each tracer's interior flux-divergence scale (rows 0-4: 0)."""
    from wxfactory_tpu_torch.kernels.check import advection_term_scale

    return advection_term_scale(torch.as_tensor(y), con).numpy()


@pytest.mark.parametrize("nel_h,nel_v,s", [(3, 2, 2), (4, 3, 3)], ids=["3x3x2s2", "4x4x3s3"])
@pytest.mark.parametrize("case", [11, 12])
def test_plain_advection_matches_jax_xla(case, nel_h, nel_v, s):
    geom, ops, topo, metric = _setup(nel_h, nel_v, s)
    x, y = _inputs(case, nel_h, nel_v, s)
    want = np.asarray(_jax_rhs(geom, ops, topo, metric)(jnp.asarray(y)))
    rhs = interop.euler3d_rhs(geom, ops, metric, advection_only=True)
    con = rhs.con
    yt, xt = torch.as_tensor(y), torch.as_tensor(x)
    halo = rhs.halo(rhs.traces(yt))
    got = e3op.euler3d_advection_plain(yt, halo, con).numpy()
    term = _term_scale(y, con)
    assert (got[:5] == 0).all() and (want[:5] == 0).all()
    assert (np.abs(got - want)[5:].reshape(got.shape[0] - 5, -1).max(axis=1) <= 1e-12 * term[5:]).all()

    # Each tracer's mass integral of the RHS: zero to round-off.
    wsg = mass_weights(ops, con).numpy()
    for r in range(5, got.shape[0]):
        assert abs((wsg * got[r]).sum()) <= 1e-14 * np.abs(wsg * got[r]).sum()

    # The stage with x and its traces (the chain's call) against the JAX RHS's.
    a, b, cdt = 1.0 / 3.0, 2.0 / 3.0, (2.0 / 3.0) * DT
    out, traces = rhs.stage(xt, yt, a, b, cdt)
    want_out = a * x + (b * y + cdt * want)
    scale = np.maximum(_row_scale(want_out), cdt * term)
    assert (np.abs(out.numpy() - want_out).reshape(out.shape[0], -1).max(axis=1) <= 1e-12 * scale).all()
    ee = np.asarray(build_euler3d_constants(ops, metric)["EE"])
    want_tr = _np_edge_traces(want_out, ee, s * s)
    assert (np.abs(traces.numpy() - want_tr).reshape(out.shape[0], -1).max(axis=1)
            <= 1e-12 * _row_scale(want_tr)).all()


@pytest.mark.parametrize("case", [11, 12])
def test_plain_advection_float32(case):
    """float32: the port's plain version and the JAX float32 XLA RHS against
    the float64 truth on the same float32-rounded inputs."""
    geom, ops, topo, metric = _setup(4, 3, 3)
    _, y = _inputs(case, 4, 3, 3)
    y32 = y.astype(np.float32)
    truth = np.asarray(_jax_rhs(geom, ops, topo, metric)(jnp.asarray(y32.astype(np.float64))))
    jax32 = np.asarray(_jax_rhs(geom, ops, topo, metric, dtype=jnp.float32)(jnp.asarray(y32)))
    rhs = interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32, advection_only=True)
    got = rhs(torch.as_tensor(y32)).numpy()
    assert got.dtype == np.float32 and (got[:5] == 0).all()
    term = _term_scale(y, interop.euler3d_rhs(geom, ops, metric, advection_only=True).con)[5:]
    err = lambda a: np.abs(a.astype(np.float64) - truth)[5:].reshape(len(term), -1).max(axis=1) / term
    assert (err(got) <= np.maximum(1e-5, 2.0 * err(jax32))).all(), (err(got), err(jax32))


INI = """
[General]
equations = euler
[System]
distribute = {distribute}
[Test_case]
case_number = {case}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
starting_step = {start}
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 3
num_elements_vertical = 2
[Grid]
grid_type = cubed_sphere
ztop = 12000
[Output_options]
output_freq = {output}
save_state_freq = {save}
base_output_file = adv
output_dir = {out}
"""


def _ini(out, case=11, integrator="tvdrk3", steps=3, output=0, save=0, start=0, distribute="off"):
    return INI.format(case=case, integrator=integrator, dt=SIM_DT[case], t_end=SIM_DT[case] * steps,
                      output=output, save=save, start=start, out=out, distribute=distribute)


_RUNS = {}


def _run_both(tmp_path_factory, case, integrator):
    """The JAX and the port's Simulation on the same INI (3 steps; fields
    written at every step), run once a module."""
    key = (case, integrator)
    if key not in _RUNS:
        base = tmp_path_factory.mktemp(f"adv{case}{integrator}")
        jsim = JSimulation(JConfiguration(_ini(base / "jax", case, integrator, output=1)))
        want = np.asarray(jsim.run())
        sim = Simulation(Configuration(_ini(base / "port", case, integrator, output=1, save=1)), device="cpu")
        got = sim.run().numpy()
        _RUNS[key] = (base, sim, got, want)
    return _RUNS[key]


@pytest.mark.parametrize("integrator", ["tvdrk3", "euler1"])
@pytest.mark.parametrize("case", [11, 12])
def test_simulation_matches_jax(tmp_path_factory, case, integrator):
    base, sim, got, want = _run_both(tmp_path_factory, case, integrator)
    assert got.shape == want.shape == ((9 if case == 11 else 6), 6, 2, 3, 3, 8)
    scale = _row_scale(want).reshape(-1, 1, 1, 1, 1, 1)
    assert np.abs((got - want) / scale).max() < 1e-12
    # The momenta: rho * the prescribed winds at t_end.
    winds = np.stack(J_WINDS[case](sim.geom, 3 * SIM_DT[case]))
    assert np.abs(got[1:4] - got[0] * winds).max() <= 1e-13 * _row_scale(got[1:4]).max()
    # rho and rho*theta unchanged to rounding, each tracer's mass conserved.
    q0 = sim.initial_q.numpy()
    assert np.abs(got[0] - q0[0]).max() <= 1e-14 * np.abs(q0[0]).max()
    wsg = mass_weights(sim.ops, sim.rhs.con).numpy()
    for r in range(5, got.shape[0]):
        m0 = (wsg * q0[r]).sum()
        assert abs((wsg * got[r]).sum() - m0) <= 1e-13 * abs(m0)
    assert abs(global_mass_3d(got, sim.ops, sim.metric) / global_mass_3d(q0, sim.ops, sim.metric) - 1) < 1e-14


def test_restart_equals_uninterrupted_run(tmp_path_factory):
    base, sim, got, _ = _run_both(tmp_path_factory, 11, "tvdrk3")
    # The uninterrupted run saved a checkpoint a step; restart from step 2.
    text = _ini(base / "port", 11, "tvdrk3", save=1, start=2)
    restarted = Simulation(Configuration(text), device="cpu")
    assert restarted.starting_step == 2
    assert torch.equal(restarted.run(), torch.as_tensor(got))


def test_netcdf_matches_jax(tmp_path_factory):
    base, _, _, _ = _run_both(tmp_path_factory, 11, "tvdrk3")
    read = lambda p: {k: np.array(v[:]) for k, v in netcdf_file(str(p), "r", mmap=False).variables.items()}
    got, want = read(base / "port" / "adv.nc"), read(base / "jax" / "adv.nc")
    assert set(got) == set(want) and "q1" not in got and "rho" in got
    for name, w in want.items():
        tol = 1e-9 if name in ("U", "V", "W") else 1e-12  # the winds as tests/test_torch_output.py holds them
        assert got[name].shape == w.shape and np.abs(got[name] - w).max() <= tol * max(np.abs(w).max(), 1e-300), name


@pytest.mark.parametrize("case", [11, 12])
def test_multi_rank_runs_refuse(tmp_path, case):
    with pytest.raises(NotImplementedError, match="item 14"):
        plan_distribution(Configuration(_ini(tmp_path, case)), 6)
    with pytest.raises(ValueError, match="shard_map"):
        plan_distribution(Configuration(_ini(tmp_path, case, distribute="shard_map")), 6)


def test_kernel_wrapper_refuses_two_tracers():
    _, ops, _, metric = _setup(3, 2, 2)
    con = interop.euler3d_constants(ops, metric, 3, 2)
    _, y = _inputs(11, 3, 2, 2)
    q = torch.as_tensor(y[:7]).contiguous()
    with pytest.raises(ValueError, match="1 or 4"):
        e3op._launch_advection(q, None, con, None, 0.0, 1.0, None, False)


def test_five_row_edge_traces_bit_for_bit():
    """The halo glue's extrapolation on a five-row state is what it was
    before it carried tracer rows (rho and rho*theta through log space,
    the momenta linear), bit for bit."""
    _, ops, _, metric = _setup(3, 2, 2)
    con = interop.euler3d_constants(ops, metric, 3, 2)
    _, y = _inputs(11, 3, 2, 2)
    q = torch.as_tensor(y[:5]).contiguous()
    ss, ee = 4, con.ee
    log_rows = lambda t: torch.cat([torch.log(t[0:1]), t[1:4], torch.log(t[4:5])])
    exp_rows = lambda t: torch.cat([torch.exp(t[0:1]), t[1:4], torch.exp(t[4:5])])
    before = torch.stack([exp_rows(log_rows(q[:, :, :, 0]) @ ee[:, 2 * ss : 3 * ss]),
                          exp_rows(log_rows(q[:, :, :, -1]) @ ee[:, 3 * ss : 4 * ss]),
                          exp_rows(log_rows(q[:, :, :, :, 0]) @ ee[:, :ss]),
                          exp_rows(log_rows(q[:, :, :, :, -1]) @ ee[:, ss : 2 * ss])], dim=1)
    assert torch.equal(e3op.edge_traces(q, con), before)
    assert torch.equal(e3op._exp_rows(e3op._log_rows(q) @ ee), exp_rows(log_rows(q) @ ee))
