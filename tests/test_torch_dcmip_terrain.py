"""DCMIP 20, 21 and 22 (3D Euler over terrain) in the port against the JAX
package's XLA form, float64 on the CPU (where the port's wrappers run their
plain versions), at small shapes.

* Initial states, geometries with topography and the Rayleigh damping
  planes (the JAX package's damping closure read through
  ``interop.rayleigh_damping``): within 1e-12 of scale (they are the same
  code on the same numbers).
* Constants: with topography the metric differs from panel to panel; the
  port keeps all six (``panel_metric``), each field equal to the JAX
  package's ``build_euler3d_constants`` entry; the one-panel build refuses
  such a metric; flat constants copied to every panel (``expand_panels``)
  give the plain operator's result bit for bit.
* The RHS against ``make_rhs_euler_cubesphere(interior="xla",
  extra_forcing=...)``: within 1e-10 of a term scale (per variable the
  larger of the RHS max and the flux divergence / gravity term of
  ``kernels/check.py::euler3d_term_scale``: DCMIP 20 at rest is a balanced
  residual of the pressure gradient against gravity over terrain), at rest
  and with seeded noise; the sponge's forcing alone against the JAX
  package's (the RHS with it minus the RHS without), on the momenta only.
* The Jacobian action (``Euler3DRHS.jtv``, ``torch.func.jvp`` of the plain
  operator) against ``jax.jvp`` of the JAX RHS, 1e-10 of each variable's
  max; the split's plain versions (prep, then apply) against it at 1e-12.
* DCMIP 20's float32 perturbation-form companion against the JAX
  ``rhs_pert``: float64 ``delta`` at 1e-11 of scale, float32 within 1e-5 of
  the float64 one's term scale (both packages').
* Both ``Simulation`` classes on the same INI: a few TVD-RK3 steps and one
  EPI2 step, within 1e-10 of each variable's max, mass within 1e-12; the
  mixed companion for 20 and none for 21/22 (as the JAX package rules).
* The tile step: each tile's constants are its own panel's slice, and
  DCMIP 20's tile step equals the global chain; the sponge's tile step
  raises (ROADMAP item 14).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.models.euler_cubesphere import build_euler3d_constants as j_constants
from wxfactory_tpu.models.euler_cubesphere import make_rhs_euler_cubesphere as j_make_rhs
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.testcases import dcmip as jd
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.geometry import make_cubed_sphere_3d, make_metric_3d
from wxfactory_tpu_torch.integrators import Tvdrk3
from wxfactory_tpu_torch.kernels.check import euler3d_term_scale
from wxfactory_tpu_torch.models import Euler3DRHS, RayleighDamping
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.ops.dfr import make_dfr_operators
from wxfactory_tpu_torch.output import global_mass_3d
from wxfactory_tpu_torch.parallel import CubedSphereTopology, TileMesh
from wxfactory_tpu_torch.parallel.shard_map_euler3d_fused import make_shard_map_euler3d_step_fused
from wxfactory_tpu_torch.simulation import Simulation, plan_distribution
from wxfactory_tpu_torch.testcases import dcmip_planet_params, initial_state_3d

torch.set_num_threads(1)

ZTOP = {20: 12000.0, 21: 30000.0, 22: 30000.0}


def _jax_case(case, nel_h, nel_v, s):
    """(geom, ops, topo, metric, q0, extra_forcing) of the JAX package."""
    from conftest import cs3d_setup
    from wxfactory_tpu.geometry.metric3d import make_metric_3d as j_metric

    scale, rotating = dcmip_planet_params(case)
    geom, ops, topo, _ = cs3d_setup(nel_h, nel_v, s, ZTOP[case], scale=scale, rotating=rotating)
    if case == 20:
        q0, geom = jd.dcmip_steady_state_mountain(geom)
        return geom, ops, topo, j_metric(geom, ops, topo), q0, None
    q0, geom, metric = jd.dcmip_schar_waves(geom, lambda g: j_metric(g, ops, topo), shear=case == 22)
    return geom, ops, topo, metric, q0, jd.make_schar_damping(geom, metric, case == 22)


def _damping(extra_forcing):
    """The port's planes of the JAX package's damping closure (or None)."""
    return None if extra_forcing is None else interop.rayleigh_damping(extra_forcing)


def _port_case(case, nel_h, nel_v, s):
    """(geom, ops, topology, metric, q0, damping) of the port."""
    scale, rotating = dcmip_planet_params(case)
    geom = make_cubed_sphere_3d(nel_h, nel_v, s, ZTOP[case], planet_scaling_factor=scale,
                                planet_is_rotating=rotating)
    ops = make_dfr_operators(s, three_d=True)
    topology = CubedSphereTopology(geom)
    q0, geom, metric, damping = initial_state_3d(geom, case, lambda g: make_metric_3d(g, ops, topology))
    return geom, ops, topology, metric, q0, damping


def _scaled(got, want, floor=None):
    """max |got - want| per variable over its scale (a variable that is 0
    everywhere, as DCMIP 20's winds, must match exactly)."""
    scale = np.maximum(np.abs(want).reshape(5, -1).max(axis=1), 1e-300)
    if floor is not None:
        scale = np.maximum(scale, floor)
    return float(np.abs((got - want) / scale.reshape((5,) + (1,) * (want.ndim - 1))).max())


def _noisy(q, seed=0):
    rng = np.random.default_rng(seed)
    out = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
    out[3] += 0.1 * q[0] * rng.standard_normal(q[0].shape)
    return out


@pytest.mark.parametrize("case", [20, 21, 22])
def test_initial_states_and_damping_match_jax(case):
    jgeom, _, _, _, jq, jforcing = _jax_case(case, 4, 3, 3)
    geom, _, _, _, q, damping = _port_case(case, 4, 3, 3)
    assert _scaled(q, jq) < 1e-12
    np.testing.assert_allclose(geom.zbot, jgeom.zbot, rtol=0, atol=1e-12 * np.abs(jgeom.zbot).max())
    np.testing.assert_allclose(geom.height, jgeom.height, rtol=0, atol=1e-12 * jgeom.ztop)
    assert e3op.has_topography(geom) and np.abs(geom.zbot).max() > 0
    if case == 20:
        assert damping is None and jforcing is None
        return
    want = interop.rayleigh_damping(jforcing)
    for name in ("mask", "u1ref", "u2ref", "u3ref"):
        got, ref = getattr(damping, name), getattr(want, name)
        assert got.shape == ref.shape == q[0].shape
        assert np.abs(got - ref).max() <= 1e-12 * max(np.abs(ref).max(), 1e-300)
    assert damping.mask.max() > 0 and damping.mask.min() == 0.0  # the sponge sits above 20 km only


@pytest.mark.parametrize("case", [20, 21])
def test_per_panel_constants_match_jax(case):
    geom, ops, _, metric, _, jforcing = _jax_case(case, 4, 3, 2)
    jc = {k: np.asarray(v) for k, v in j_constants(ops, metric).items()}
    con = interop.euler3d_constants(ops, metric, 4, 3, geom=geom, damping=_damping(jforcing))
    assert con.panel_metric and con.fields.shape == (e3op.N_FIELDS, 6, 3, 4, 4, 8)
    fld = con.fields.numpy()
    want = [jc["sqrtG"], jc["inv_sqrtG"], jc["inv_dzdeta"]] + [jc["hc"][a, b] for a, b in e3op.H_PAIRS]
    want += [jc["chr"][a, 3 + j] for a in range(3) for j in range(6)] + [jc["wpres_int"]]
    for i, w in enumerate(want):
        np.testing.assert_array_equal(fld[i], w)
    for mine, sg, hr in ((con.itf_x, "sg_i", "hr_i"), (con.itf_y, "sg_j", "hr_j"), (con.itf_z, "sg_k", "hr_k")):
        np.testing.assert_array_equal(mine.numpy()[0], jc[sg])
        np.testing.assert_array_equal(mine.numpy()[1:], jc[hr])
    # The metric differs across panels: the one-panel build refuses it.
    assert np.abs(fld[0] - fld[0][:1]).max() > 1e-6 * np.abs(fld[0]).max()
    with pytest.raises(ValueError, match="panel_metric"):
        e3op.build_constants(ops, metric, 4, 3)
    assert (con.sponge is not None) == (case != 20)
    if con.sponge is not None:
        d = interop.rayleigh_damping(jforcing)
        sp = con.sponge.numpy()
        np.testing.assert_array_equal(sp[0], d.mask)
        for i, u in enumerate((d.u1ref, d.u2ref, d.u3ref)):
            np.testing.assert_array_equal(sp[1 + i], d.mask * u)


@pytest.mark.parametrize("case,s,noisy", [(20, 2, False), (20, 3, False), (20, 3, True), (21, 3, False),
                                          (21, 3, True), (22, 3, True)],
                         ids=["20-s2-rest", "20-s3-rest", "20-s3-noisy", "21-s3", "21-s3-noisy", "22-s3-noisy"])
def test_rhs_matches_jax_xla(case, s, noisy):
    geom, ops, topo, metric, q0, jforcing = _jax_case(case, 4, 3, s)
    q = _noisy(q0) if noisy else q0
    want = np.asarray(j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla",
                                 extra_forcing=jforcing)(jnp.asarray(q)))
    rhs = interop.euler3d_rhs(geom, ops, metric, damping=_damping(jforcing))
    qt = interop.to_tensor(q)
    got = rhs(qt).numpy()
    floor = euler3d_term_scale(qt, rhs.con).numpy()
    assert _scaled(got, want, floor) < 1e-10
    if case == 20 and s == 3 and not noisy:
        # At rest over terrain the RHS is the pressure gradient's residual
        # against gravity: far below the gravity term it balances (at s = 2
        # the 4x3 grid resolves the mountain too coarsely for that).
        assert np.abs(got[3]).max() < 1e-2 * floor[3]


@pytest.mark.parametrize("case", [21, 22])
def test_sponge_forcing_matches_jax_extra_forcing_on_the_momenta(case):
    geom, ops, topo, metric, q0, jforcing = _jax_case(case, 4, 3, 3)
    q = _noisy(q0, seed=3)
    jrhs = lambda f: np.asarray(j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla",
                                           extra_forcing=f)(jnp.asarray(q)))
    want = jrhs(jforcing) - jrhs(None)
    qt = interop.to_tensor(q)
    got = (interop.euler3d_rhs(geom, ops, metric, damping=_damping(jforcing))(qt)
           - interop.euler3d_rhs(geom, ops, metric)(qt)).numpy()
    assert np.array_equal(got[0], np.zeros_like(got[0])) and np.array_equal(got[4], np.zeros_like(got[4]))
    scale = np.abs(want[1:4]).max()
    assert scale > 0 and np.abs(got[1:4] - want[1:4]).max() < 1e-10 * scale


def _inputs(q0, seed=7):
    rng = np.random.default_rng(seed)
    dq = 1e-4 * q0 * rng.standard_normal(q0.shape)
    v = rng.standard_normal(q0.shape) * np.abs(q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1) * 1e-3
    return dq, v


@pytest.mark.parametrize("case", [20, 21])
def test_tangent_matches_jax_jvp(case):
    geom, ops, topo, metric, q0, jforcing = _jax_case(case, 4, 3, 3)
    dq, v = _inputs(q0)
    jrhs = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla", extra_forcing=jforcing)
    want = np.asarray(jax.jit(lambda a, b: jax.jvp(jrhs, (a,), (b,))[1])(jnp.asarray(q0 + dq), jnp.asarray(v)))
    rhs = interop.euler3d_rhs(geom, ops, metric, damping=_damping(jforcing))
    q, vt = interop.to_tensor(q0 + dq), interop.to_tensor(v)
    got = rhs.jtv(q, vt).numpy()
    assert _scaled(got, want) < 1e-10
    # The split's plain versions (the kernels' twins) against the same action.
    traces = e3op.edge_traces(q, rhs.con)
    halo_q = rhs.halo(traces)
    halo_v = rhs.halo(e3op.edge_traces_tangent(q, vt, rhs.con, traces))
    split = e3op.euler3d_tangent(q, vt, halo_q, halo_v, rhs.con).numpy()
    assert _scaled(split, got) < 1e-12


def test_case20_prep_and_apply_plain_match_the_plain_tangent_in_perturbation_form():
    geom, ops, topology, metric, q0, _ = _port_case(20, 4, 3, 2)
    rhs = Euler3DRHS(geom, ops, metric, device="cpu", topology=topology, perturbation_base=q0)
    dq, v = _inputs(q0, seed=11)
    q, vt = torch.as_tensor(q0 + dq), torch.as_tensor(v)
    prep = rhs.jtv_prep(q)
    want = rhs.jtv_apply(prep, vt)  # torch.func.jvp of the plain perturbation form
    q_in, qa, traces, halo_q, _ = prep
    halo_v = rhs.halo(e3op.edge_traces_tangent(qa, vt, rhs.con, traces))
    got = e3op.euler3d_tangent(q_in, vt, halo_q, halo_v, rhs.con, pert=rhs.pert)
    assert _scaled(got.numpy(), want.numpy()) < 1e-12


def test_case20_float32_companion_matches_jax_rhs_pert():
    geom, ops, topo, metric, q0, _ = _jax_case(20, 4, 3, 3)
    dq, v = _inputs(q0, seed=5)
    q = q0 + dq
    j64 = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla", perturbation_base=jnp.asarray(q0))
    j32 = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float32, interior="xla", perturbation_base=jnp.asarray(q0))
    p64 = interop.euler3d_rhs(geom, ops, metric, perturbation_base=q0)
    p32 = interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32, perturbation_base=q0)
    assert p64.con.panel_metric and p32.con.panel_metric
    want64 = np.asarray(j64.delta(jnp.asarray(dq)))
    got64 = p64.delta(torch.as_tensor(dq)).numpy()
    floor = euler3d_term_scale(torch.as_tensor(q), p64.con).numpy()
    assert _scaled(got64, want64, floor) < 1e-11
    got32 = p32.delta(torch.as_tensor(dq, dtype=torch.float32)).double().numpy()
    want32 = np.asarray(j32.delta(jnp.asarray(dq, dtype=jnp.float32))).astype(np.float64)
    assert _scaled(got32, want64, floor) < 1e-5 and _scaled(want32, want64, floor) < 1e-5
    # Its Jacobian action J(q0 + dq).v against jax.jvp of the JAX delta.
    jv = np.asarray(jax.jvp(j64.delta, (jnp.asarray(dq),), (jnp.asarray(v),))[1])
    assert _scaled(p64.jtv(torch.as_tensor(q), torch.as_tensor(v)).numpy(), jv) < 1e-10


def test_expanded_flat_constants_give_the_plain_operator_bit_for_bit():
    from conftest import cs3d_setup
    from wxfactory_tpu.testcases.dcmip import dcmip_gravity_wave

    geom, ops, topo, metric = cs3d_setup(3, 2, 2)
    q = torch.as_tensor(_noisy(dcmip_gravity_wave(geom)))
    con = interop.euler3d_constants(ops, metric, 3, 2)
    cx = e3op.expand_panels(con)
    topology = CubedSphereTopology(geom)
    halo = e3op.halo_from_traces(e3op.edge_traces(q, con), topology)
    assert not con.panel_metric and cx.panel_metric and cx.fields.shape[1] == 6
    assert torch.equal(e3op.euler3d_operator(q, halo, cx), e3op.euler3d_operator(q, halo, con))
    coef = e3op.euler3d_tangent_prep(q, halo, con)
    assert torch.equal(e3op.euler3d_tangent_prep(q, halo, cx).values, coef.values)
    assert torch.equal(e3op.euler3d_tangent_apply(q * 1e-3, halo, coef, cx),
                       e3op.euler3d_tangent_apply(q * 1e-3, halo, coef, con))


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
exponential_solver = kiops
tolerance = 1e-7{extra}
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = 4
num_elements_vertical = 3
[Grid]
grid_type = cubed_sphere
ztop = {ztop}
[Output_options]
output_dir = {out}
"""


def _ini(tmp_path, case, integrator, dt, steps, s=3, extra=""):
    return INI.format(case=case, dt=dt, t_end=dt * steps, integrator=integrator, s=s, ztop=ZTOP[case], extra=extra,
                      out=tmp_path)


@pytest.mark.parametrize("case", [20, 21, 22])
def test_tvdrk3_simulation_matches_jax(tmp_path, case):
    text = _ini(tmp_path, case, "tvdrk3", 0.5, 4)
    want = np.asarray(JSimulation(JConfiguration(text)).run())
    sim = Simulation(Configuration(text), device="cpu")
    assert sim.rhs.con.panel_metric and (sim.rhs.con.sponge is not None) == (case != 20)
    got = sim.run().numpy()
    assert got.shape == want.shape == (5, 6, 3, 4, 4, 27)
    assert _scaled(got, want) < 1e-10
    m0 = global_mass_3d(sim.initial_q, sim.ops, sim.metric)
    assert abs(global_mass_3d(got, sim.ops, sim.metric) - m0) / abs(m0) < 1e-12


@pytest.mark.parametrize("case,dt", [(20, 5.0), (21, 2.0)], ids=["20", "21"])
def test_epi2_step_of_both_simulations_matches(tmp_path, case, dt):
    """One EPI2 + KIOPS step of both Simulations from the same checkpoint:
    the initial state with seeded noise of 1e-4 (saved as step 1, resumed
    with ``starting_step = 1``). At the unperturbed DCMIP 21 state the
    Rusanov eigenvalue max(aL, aR) ties at interfaces to the rounding of
    each implementation, where the one-sided derivatives differ: two correct
    Jacobian actions there part by 4e-4 of scale (the kink of the SW and
    dcmip31 linearisation points, as in test_torch_ros2_precondition.py).
    The EPI2 step's mass drift, the JAX package's own to 1e-14 (at DCMIP
    20's balanced state the Krylov combination cancels and both move mass
    by the same ~1e-11)."""
    from wxfactory_tpu_torch.output.state import save_state

    text = _ini(tmp_path, case, "epi2", dt, 2).replace("tolerance = 1e-7", "tolerance = 1e-7\nstarting_step = 1")
    start = Simulation(Configuration(text.replace("starting_step = 1", "starting_step = 0")), device="cpu")
    q1 = start.initial_q.numpy() * (1.0 + 1e-4 * np.random.default_rng(3).standard_normal(start.initial_q.shape))
    save_state(q1, Configuration(text), start.output.state_file_name(1))
    want = np.asarray(JSimulation(JConfiguration(text)).run())
    sim = Simulation(Configuration(text), device="cpu")
    assert sim.starting_step == 1 and np.array_equal(sim.initial_q.numpy(), q1)
    got = sim.run().numpy()
    assert _scaled(got, want) < 1e-10
    mass = lambda q: global_mass_3d(q, sim.ops, sim.metric)
    m1 = mass(q1)
    assert abs((mass(got) - m1) - (mass(want) - m1)) / m1 < 1e-14


@pytest.mark.parametrize("case", [20, 21, 22])
def test_mixed_companion_only_for_case_20(tmp_path, case, capsys):
    text = _ini(tmp_path, case, "epi2", 30.0, 1, s=2, extra="\nmixed_precision_krylov = 1").replace(
        "exponential_solver = kiops", "exponential_solver = kiops_jit")
    sim = Simulation(Configuration(text), device="cpu")
    if case == 20:
        assert sim.rhs32 is not None and sim.rhs32.pert is not None and sim.rhs32.con.panel_metric
    else:
        assert sim.rhs32 is None and "no effect" in capsys.readouterr().out


def test_tile_constants_take_their_own_panel():
    geom, ops, topology, metric, _, _ = _port_case(20, 4, 3, 2)
    con = e3op.build_constants(ops, metric, 4, 3, panel_metric=True)
    for panel in range(6):
        for ey0, ex0 in ((0, 0), (0, 2), (2, 0), (2, 2)):
            tile = e3op.tile_constants(con, ey0, ex0, 2, panel)
            assert tile.npanel == 1 and not tile.panel_metric
            ys, xs = slice(ey0, ey0 + 2), slice(ex0, ex0 + 2)
            assert torch.equal(tile.fields, con.fields[:, panel, :, ys, xs])
            assert torch.equal(tile.itf_x, con.itf_x[:, panel, :, ys, ex0 : ex0 + 3])
            assert torch.equal(tile.itf_y, con.itf_y[:, panel, :, ey0 : ey0 + 3, xs])
            assert torch.equal(tile.itf_z, con.itf_z[:, panel, :, ys, xs])


@pytest.mark.parametrize("n", [1, 2])
def test_case20_tile_step_equals_the_global_chain(n):
    geom, ops, topology, metric, q0, _ = _port_case(20, 4, 3, 2)
    step = make_shard_map_euler3d_step_fused(geom, ops, metric, TileMesh(n), 0.5, dtype=torch.float64, device="cpu",
                                             topology=topology)
    chain = Tvdrk3(Euler3DRHS(geom, ops, metric, device="cpu", topology=topology))
    q = qc = torch.as_tensor(q0)
    for _ in range(3):
        q, qc = step(q), chain.step(qc, 0.5)
    assert torch.equal(q, qc)


def test_sponge_cases_refuse_the_tile_step_and_the_perturbation_form(tmp_path):
    cfg = lambda **kw: Configuration(_ini(tmp_path, 21, "tvdrk3", 0.5, 2).replace(
        "distribute = off", f"distribute = {kw.get('dist', 'auto')}"))
    with pytest.raises(NotImplementedError, match="item 14"):
        plan_distribution(cfg(), 6)
    with pytest.raises(NotImplementedError, match="item 14"):
        plan_distribution(cfg(dist="shard_map"), 1)
    assert plan_distribution(cfg(), 1) is None
    case20 = Configuration(_ini(tmp_path, 20, "tvdrk3", 0.5, 2).replace("distribute = off", "distribute = auto"))
    assert plan_distribution(case20, 6) == 1
    geom, ops, topology, metric, q0, damping = _port_case(21, 4, 3, 2)
    assert isinstance(damping, RayleighDamping)
    con = e3op.build_constants(ops, metric, 4, 3, panel_metric=True, damping=damping)
    with pytest.raises(NotImplementedError, match="item 14"):
        e3op.tile_constants(con, 0, 0, 4, 0)
    with pytest.raises(ValueError, match="damping"):
        Euler3DRHS(geom, ops, metric, device="cpu", topology=topology, perturbation_base=q0, damping=damping)
    with pytest.raises(ValueError, match="panel_metric"):
        e3op.build_constants(ops, metric, 4, 3, damping=damping)
