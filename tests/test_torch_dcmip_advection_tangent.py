"""The Jacobian action of the DCMIP 11/12 tracer-advection operator in the
port against the JAX package, on the CPU (the same numpy inputs from a
seed through ``jax.jvp`` of the jitted JAX advection-only XLA RHS and
through the port's plain prep + apply pair, the CPU side of the CUDA
kernels of csrc/euler3d_advection_tangent.cu):

* J.v at 3x3x2, s = 2 and 4x4x3, s = 3, cases 11 (4 tracers) and 12 (1),
  in a random direction with every row set: float64 within 1e-12 of each
  tracer row's J.v term scale, rows 0-4 exactly 0; float32 within twice
  the JAX float32 jvp's distance from the float64 truth;
* the ties: a state with zero momenta in half the element columns (zero
  normal speed on both sides of their interfaces, where d max(|vL|, |vR|)
  takes jax.jvp's rules) and the ground and the lid, against jax.jvp at
  1e-12;
* linearity: J.(0, dT) equals the plain advection RHS at (rho, m,
  rho*theta, dT) within 1e-14 of scale;
* mass: each tracer's mass integral of J.v in a direction that leaves rows
  0-4 at 0 (what the Krylov loop applies) is 0 within 1e-14 of its
  absolute integral;
* the halo glue: ``edge_traces_tangent`` on five rows bit for bit the
  five-row formula, its tracer rows against jax.jvp of the JAX package's
  trace extrapolation;
* the port's ``Simulation(device="cpu")`` against the JAX ``Simulation`` at
  3x3x2, s = 2, 2 steps: EPI2 + KIOPS on 11, Ros2 on 12, Crank-Nicolson on
  11, within 1e-10 of each row's max with the same iteration counts a step;
* the refusals: Ros2 with p-mg or fv-mg on 11/12 raises naming ROADMAP
  item 19; ``mixed_precision_krylov`` on 11 prints the JAX package's
  warning and runs.
"""

import numpy as np
import pytest
import torch
from conftest import cs3d_setup

import jax
import jax.numpy as jnp
from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.models.euler_cubesphere import build_euler3d_constants, make_rhs_euler_cubesphere
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.testcases import dcmip as jdcmip
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.kernels.check import (advection_tangent_term_scale, advection_term_scale, mass_weights,
                                               zero_momenta_columns)
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)

ZTOP = 12000.0
J_INIT = {11: jdcmip.dcmip_advection_deformation, 12: jdcmip.dcmip_advection_hadley}
SHAPES = [(3, 2, 2), (4, 3, 3)]
SHAPE_IDS = ["3x3x2s2", "4x4x3s3"]


def _setup(nel_h, nel_v, s):
    """The JAX package's (geom, ops, topology, metric) on DCMIP 11/12's planet (read-only cache)."""
    return cs3d_setup(nel_h, nel_v, s, ztop=ZTOP, scale=1.0, rotating=True)


_JAX_RHS = {}


def _jax_rhs(nel_h, nel_v, s, dtype=jnp.float64):
    """The JAX advection-only XLA RHS, jitted once a shape and dtype."""
    key = (nel_h, nel_v, s, dtype)
    if key not in _JAX_RHS:
        geom, ops, topo, metric = _setup(nel_h, nel_v, s)
        _JAX_RHS[key] = jax.jit(make_rhs_euler_cubesphere(geom, ops, metric, topo, advection_only=True, dtype=dtype))
    return _JAX_RHS[key]


def _inputs(case, nel_h, nel_v, s, seed=3):
    """A noisy state of the case (1e-3 relative on every row, 0.1 rho
    N(0,1) on each tracer) and a direction of 1e-3 of each row's max
    N(0,1), every row set."""
    q0 = J_INIT[case](_setup(nel_h, nel_v, s)[0])
    rng = np.random.default_rng(seed)
    q = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    q[5:] += 0.1 * q0[0] * rng.standard_normal(q[5:].shape)
    v = 1e-3 * np.abs(q).reshape(q.shape[0], -1).max(axis=1).reshape(-1, 1, 1, 1, 1, 1) * rng.standard_normal(q.shape)
    return q, v


def _rhs(nel_h, nel_v, s, dtype=torch.float64):
    geom, ops, _, metric = _setup(nel_h, nel_v, s)
    return interop.euler3d_rhs(geom, ops, metric, dtype=dtype, advection_only=True)


def _jvp(nel_h, nel_v, s, q, v, dtype=jnp.float64):
    _, out = jax.jvp(_jax_rhs(nel_h, nel_v, s, dtype), (jnp.asarray(q, dtype),), (jnp.asarray(v, dtype),))
    return np.asarray(out)


def _scaled_err(got, want, scale):
    """Per-row max error over the scale (rows with scale 0 must be exact)."""
    err = np.abs(np.asarray(got, np.float64) - want).reshape(want.shape[0], -1).max(axis=1)
    return np.where(scale > 0, err / np.where(scale > 0, scale, 1.0), err)


def _scale(q, v, con, want):
    """Each tracer row's J.v scale: the larger of its max and its term scale."""
    term = advection_tangent_term_scale(torch.as_tensor(q), torch.as_tensor(v), con).numpy()
    scale = np.maximum(np.abs(want).reshape(want.shape[0], -1).max(axis=1), term)
    scale[:5] = 0.0
    return scale


@pytest.mark.parametrize("nel_h,nel_v,s", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("case", [11, 12])
def test_plain_tangent_matches_jax_jvp(case, nel_h, nel_v, s):
    q, v = _inputs(case, nel_h, nel_v, s)
    want = _jvp(nel_h, nel_v, s, q, v)
    rhs = _rhs(nel_h, nel_v, s)
    got = rhs.jtv(torch.as_tensor(q), torch.as_tensor(v)).numpy()
    assert (got[:5] == 0).all() and (want[:5] == 0).all()
    assert (_scaled_err(got, want, _scale(q, v, rhs.con, want)) <= 1e-12).all()


@pytest.mark.parametrize("case", [11, 12])
def test_plain_tangent_float32(case):
    """float32: the port's plain pair and the JAX float32 jvp against the
    float64 truth on the same float32-rounded inputs."""
    q, v = _inputs(case, 4, 3, 3)
    q32, v32 = q.astype(np.float32), v.astype(np.float32)
    truth = _jvp(4, 3, 3, q32.astype(np.float64), v32.astype(np.float64))
    jax32 = _jvp(4, 3, 3, q32, v32, dtype=jnp.float32)
    rhs = _rhs(4, 3, 3, dtype=torch.float32)
    got = rhs.jtv(torch.as_tensor(q32), torch.as_tensor(v32)).numpy()
    assert got.dtype == np.float32 and (got[:5] == 0).all()
    scale = _scale(q, v, _rhs(4, 3, 3).con, truth)
    err_got, err_jax = _scaled_err(got, truth, scale)[5:], _scaled_err(jax32, truth, scale)[5:]
    assert (err_got <= 2.0 * err_jax).all(), (err_got, err_jax)


@pytest.mark.parametrize("case", [11, 12])
def test_ties_match_jax_jvp(case):
    """Zero normal speed on both sides of the interfaces between the zeroed
    columns (the tie of max(|vL|, |vR|) at 0, and the ground's and the
    lid's mirror everywhere), against jax.jvp."""
    q, v = _inputs(case, 4, 3, 3, seed=5)
    q = zero_momenta_columns(torch.as_tensor(q)).numpy()
    want = _jvp(4, 3, 3, q, v)
    rhs = _rhs(4, 3, 3)
    got = rhs.jtv(torch.as_tensor(q), torch.as_tensor(v)).numpy()
    assert (got[:5] == 0).all()
    assert (_scaled_err(got, want, _scale(q, v, rhs.con, want)) <= 1e-12).all()


@pytest.mark.parametrize("case", [11, 12])
def test_tracer_linearity_and_mass(case):
    """J.(0, dT) is the advection RHS at (rho, m, rho*theta, dT); each
    tracer's mass of J.v in a direction with rows 0-4 at 0 is 0."""
    q, v = _inputs(case, 4, 3, 3)
    rhs = _rhs(4, 3, 3)
    con = rhs.con
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    vt[:5] = 0.0
    got = rhs.jtv(qt, vt)
    q_t = torch.cat([qt[:5], vt[5:]])
    want = e3op.euler3d_advection_plain(q_t, rhs.halo(rhs.traces(q_t)), con)
    scale = advection_term_scale(q_t, con).numpy()
    assert (_scaled_err(got.numpy(), want.numpy(), scale) <= 1e-14).all()
    wsg = mass_weights(_setup(4, 3, 3)[1], con)
    for r in range(5, got.shape[0]):
        weighted = wsg * got[r]
        assert abs(float(weighted.sum())) <= 1e-14 * float(weighted.abs().sum())


def test_plain_pair_rhs_and_one_call_agree_with_the_model():
    """The one-call plain tangent is the model's CPU J.v (the plain prep
    and apply through ``jtv_prep``/``jtv_apply``) bit for bit."""
    q, v = _inputs(11, 3, 2, 2)
    rhs = _rhs(3, 2, 2)
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    want = rhs.jtv(qt, vt)
    traces = e3op.edge_traces(qt, rhs.con)
    halo_v = rhs.halo(e3op.edge_traces_tangent(qt, vt, rhs.con, traces))
    assert torch.equal(e3op.euler3d_advection_tangent_plain(qt, vt, rhs.halo(traces), halo_v, rhs.con), want)


def test_edge_traces_tangent_tracer_rows():
    """Five rows: the five-row formula bit for bit. Tracer rows: jax.jvp of
    the JAX package's panel-edge extrapolation."""
    _, ops, _, metric = _setup(3, 2, 2)
    con = interop.euler3d_constants(ops, metric, 3, 2)
    q, v = _inputs(11, 3, 2, 2)
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    ss, ee = 4, con.ee
    q5, v5 = qt[:5].contiguous(), vt[:5].contiguous()
    traces5 = e3op.edge_traces(q5, con)
    lt = lambda sl: torch.cat([v5[0:1][sl] / q5[0:1][sl], v5[1:4][sl], v5[4:5][sl] / q5[4:5][sl]])
    raw = torch.stack([lt(np.s_[:, :, :, 0]) @ ee[:, 2 * ss : 3 * ss], lt(np.s_[:, :, :, -1]) @ ee[:, 3 * ss : 4 * ss],
                       lt(np.s_[:, :, :, :, 0]) @ ee[:, :ss], lt(np.s_[:, :, :, :, -1]) @ ee[:, ss : 2 * ss]], dim=1)
    before = torch.cat([traces5[0:1] * raw[0:1], raw[1:4], traces5[4:5] * raw[4:5]])
    assert torch.equal(e3op.edge_traces_tangent(q5, v5, con), before)

    jee = jnp.asarray(build_euler3d_constants(ops, metric)["EE"])

    def jax_traces(a):
        lg = jnp.concatenate([jnp.log(a[0:1]), a[1:4], jnp.log(a[4:5]), a[5:]])
        ex = lambda t: jnp.concatenate([jnp.exp(t[0:1]), t[1:4], jnp.exp(t[4:5]), t[5:]])
        return jnp.stack([ex(lg[:, :, :, 0] @ jee[:, 2 * ss : 3 * ss]), ex(lg[:, :, :, -1] @ jee[:, 3 * ss : 4 * ss]),
                          ex(lg[:, :, :, :, 0] @ jee[:, :ss]), ex(lg[:, :, :, :, -1] @ jee[:, ss : 2 * ss])], axis=1)

    _, want = jax.jvp(jax_traces, (jnp.asarray(q),), (jnp.asarray(v),))
    want = np.asarray(want)
    got = e3op.edge_traces_tangent(qt, vt, con).numpy()
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1).reshape(-1, 1, 1, 1, 1, 1)
    assert got.shape == want.shape and np.abs((got - want) / scale).max() <= 1e-14


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
time_integrator = {integrator}
exponential_solver = {solver}
linear_solver = fgmres
tolerance = 1e-7
mixed_precision_krylov = {mixed}
[Preconditioning]
preconditioner = {pre}
[Spatial_discretization]
num_solpts = 2
num_elements_horizontal = 3
num_elements_vertical = 2
[Grid]
grid_type = cubed_sphere
ztop = 12000
[Output_options]
output_freq = 0
save_state_freq = 0
output_dir = {out}
"""
SIM_DT = {11: 18.75, 12: 0.5859375}


def _ini(out, case, integrator, solver="kiops", pre="none", mixed=0, steps=2):
    return INI.format(case=case, dt=SIM_DT[case], t_end=steps * SIM_DT[case], integrator=integrator, solver=solver,
                      pre=pre, mixed=mixed, out=out)


def _run(sim):
    """Run a Simulation of either package, recording the iterations of every step."""
    its, step = [], sim.integrator.step

    def counted(q, dt):
        out = step(q, dt)
        its.append(int(sim.integrator.solver_info.total_num_it))
        return out

    sim.integrator.step = counted
    return np.asarray(sim.run()), its


@pytest.mark.parametrize("integrator,case", [("epi2", 11), ("ros2", 12), ("crank_nicolson", 11)])
def test_simulation_matches_jax(tmp_path, integrator, case):
    want, want_its = _run(JSimulation(JConfiguration(_ini(tmp_path / "jax", case, integrator))))
    sim = Simulation(Configuration(_ini(tmp_path / "port", case, integrator)), device="cpu")
    got, got_its = _run(sim)
    assert got_its == want_its and len(got_its) == 2 and all(i > 0 for i in got_its)
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1).reshape(-1, 1, 1, 1, 1, 1)
    assert np.isfinite(got).all() and np.abs((got - want) / scale).max() <= 1e-10


@pytest.mark.parametrize("pre,case", [("p-mg", 11), ("p-mg", 12), ("fv-mg", 11)])
def test_multigrid_refuses_naming_item_19(tmp_path, pre, case):
    with pytest.raises(NotImplementedError, match="item 19"):
        Simulation(Configuration(_ini(tmp_path, case, "ros2", pre=pre)), device="cpu")


def test_mixed_precision_krylov_warns_and_runs(tmp_path, capsys):
    sim = Simulation(Configuration(_ini(tmp_path, 11, "epi2", solver="kiops_jit", mixed=1, steps=1)), device="cpu")
    assert sim.rhs32 is None
    assert "no f32 companion RHS is available" in capsys.readouterr().out
    q = sim.run()
    assert q.shape == (9, 6, 2, 3, 3, 8) and bool(torch.isfinite(q).all())


def test_advection_kernels_refuse_what_they_do_not_take():
    _, ops, _, metric = _setup(3, 2, 2)
    con = interop.euler3d_constants(ops, metric, 3, 2)
    with pytest.raises(ValueError, match="1 or 4"):
        e3op._check_advection_kernel(con, 2, "euler3d_advection_tangent_prep")
    with pytest.raises(ValueError, match="one panel's metric"):
        e3op._check_advection_kernel(e3op.expand_panels(con), 4, "euler3d_advection_tangent_apply")


def test_profile_classes_the_advection_kernels():
    from wxfactory_tpu_torch.profile import kernel_class

    name = "void (anonymous namespace)::euler3d_advection_{}_kernel<double, 3, 4>(double const*)"
    for kernel in ("tangent_prep_node", "tangent_prep_interface", "tangent_interface", "tangent_volume"):
        assert kernel_class(name.format(kernel)) == "tangent_kernel"
    for kernel in ("interface", "volume"):
        assert kernel_class(name.format(kernel)) == "rhs_kernel"
