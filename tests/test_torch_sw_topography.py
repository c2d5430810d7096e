"""Bottom topography in the port's shallow-water operator (Williamson cases
5 and 10) against the JAX package, on the CPU (the plain versions; the
kernels with topography are held against these plain versions on the card,
tests/test_torch_kernel_cuda.py and chip_smoke.py phase 31).

* The RHS with case-5 and case-10 topography (a seeded 1e-3 relative
  perturbation of each case's state) against the JAX XLA RHS within 1e-12
  of each variable's term scale (the max of inv_sqrtG * div(F)), float64.
* J.v (the CPU's plain tangent, ``torch.func.jvp``) against ``jax.jvp`` of
  the JAX RHS, and the plain split (``sw_tangent_prep_plain`` then
  ``sw_tangent_apply_plain`` with topography) against the same, within
  1e-12 of each variable's max.
* Case 5's balance: its RHS finite and equal to the JAX one; the lake at
  rest (h + hsurf constant, no wind) moves no mass and keeps its momentum
  tendency below 5 % of the same state's without the topography terms.
* TVD-RK3 and EPI3 + pmex steps of case 5 through ``Simulation`` against
  the JAX ``Simulation`` on the same INI: the same Krylov statistics,
  states within 1e-9 of each variable's max, blockstats mass drift below
  1e-12, and the energy diagnostic with the topography's potential term.
* The perturbation form and the float32 mixed companion carry it (their
  parity with the JAX package: tests/test_torch_sw_pert_topography.py);
  every form that does not refuses it: ``packed_run``, the tile step (the
  JAX package has neither with topography), and the operator's halo-plane
  mode and trace emission.
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.geometry import make_cubed_sphere_2d as j_geom
from wxfactory_tpu.geometry import make_metric_2d as j_metric
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_ops
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.testcases import case_unsteady_zonal as j_case10
from wxfactory_tpu.testcases import williamson_case5 as j_case5
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.config import Configuration
from wxfactory_tpu_torch.kernels import check
from wxfactory_tpu_torch.models import make_rhs_shallow_water
from wxfactory_tpu_torch.ops import sw_operator as swop
from wxfactory_tpu_torch.simulation import Simulation

torch.set_num_threads(1)

NEL, S = 4, 3


def _scaled(got, want, scale=None):
    want = np.asarray(want)
    scale = np.abs(want).reshape(3, -1).max(axis=1) if scale is None else np.asarray(scale)
    return float((np.abs(np.asarray(got) - want).reshape(3, -1).max(axis=1) / scale).max())


@pytest.fixture(scope="module", params=[5, 10])
def setup(request):
    geom, ops, metric = j_geom(NEL, S), j_ops(S), j_metric(j_geom(NEL, S))
    q0, topo = (j_case5 if request.param == 5 else j_case10)(geom, ops)
    rng = np.random.default_rng(3)
    q = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    v = 1e-3 * np.abs(q0).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1) * rng.standard_normal(q0.shape)
    jrhs = j_make_rhs(geom, ops, metric, topo=topo, interior="xla")
    trhs = interop.shallow_water_rhs(geom, ops, metric, topo=topo)
    return request.param, q, v, jrhs, trhs, topo, metric


def test_rhs_with_topography_matches_jax(setup):
    _, q, _, jrhs, trhs, topo, metric = setup
    want = np.asarray(jrhs(jnp.asarray(q)))
    qt = torch.as_tensor(q)
    got = trhs(qt).numpy()
    term = check.flux_divergence_scale(qt, trhs.con).numpy()
    assert _scaled(got, want, term) < 1e-12
    assert trhs.topo is not None and swop.plain_calls > 0
    planes = interop.sw_topography(topo, metric)
    assert all(torch.equal(getattr(planes, k), getattr(trhs.topo, k)) for k in ("hsurf", "hsurf_x", "hsurf_y", "force"))


def test_tangent_with_topography_matches_jax_jvp(setup):
    _, q, v, jrhs, trhs, _, _ = setup
    want = np.asarray(jax.jvp(jrhs, (jnp.asarray(q),), (jnp.asarray(v),))[1])
    qt, vt = torch.as_tensor(q), torch.as_tensor(v)
    assert _scaled(trhs.jtv(qt, vt).numpy(), want) < 1e-12
    coef = swop.sw_tangent_prep_plain(qt, trhs.con, trhs.topology, trhs.topo)
    split = swop.sw_tangent_apply_plain(coef, vt, trhs.con, trhs.topology, trhs.topo)
    assert _scaled(split.numpy(), want) < 1e-12


def test_case5_balance():
    geom, ops, metric = j_geom(NEL, 4), j_ops(4), j_metric(j_geom(NEL, 4))
    q0, topo = j_case5(geom, ops)
    want = np.asarray(j_make_rhs(geom, ops, metric, topo=topo, interior="xla")(jnp.asarray(q0)))
    rhs = interop.shallow_water_rhs(geom, ops, metric, topo=topo)
    got = rhs(torch.as_tensor(q0)).numpy()
    assert np.all(np.isfinite(got)) and _scaled(got, want) < 1e-12
    h = 5960.0 - np.asarray(topo.hsurf)
    rest = torch.as_tensor(np.stack([h, 0.0 * h, 0.0 * h]))
    balanced = rhs(rest).numpy()
    unbalanced = interop.shallow_water_rhs(geom, ops, metric)(rest).numpy()
    assert np.abs(balanced[0]).max() <= 1e-12 * np.abs(h).max()
    for row in (1, 2):
        assert np.abs(balanced[row]).max() < 0.05 * np.abs(unbalanced[row]).max()


INI = """
[General]
equations = shallow_water
[System]
distribute = off
[Test_case]
case_number = {case}
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = pmex
tolerance = 1e-7
verbose_solver = 1
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = 4
[Grid]
grid_type = cubed_sphere
[Output_options]
stat_freq = 1
output_dir = {out}
"""


@pytest.mark.parametrize("integrator,dt,steps", [("tvdrk3", 300.0, 3), ("epi3", 1800.0, 3)])
def test_case5_simulation_matches_jax(tmp_path, integrator, dt, steps):
    text = INI.format(case=5, dt=dt, t_end=dt * steps, integrator=integrator, out=tmp_path)
    with contextlib.redirect_stdout(io.StringIO()) as jlog:
        want = np.asarray(JSimulation(JConfiguration(text)).run())
    with contextlib.redirect_stdout(io.StringIO()) as log:
        sim = Simulation(Configuration(text), device="cpu")
        got = sim.run().numpy()
    assert sim.topo is not None and sim.rhs.topo is not None and sim.output.topo is not None
    assert _scaled(got, want) < 1e-9
    krylov = lambda t: re.findall(r"converged at iteration (\d+) \((\d+) substeps, (\d+) rejected\)", t)
    assert krylov(log.getvalue()) == krylov(jlog.getvalue())
    drifts = [float(line.split("=")[1]) for line in log.getvalue().splitlines()
              if "normalized error for mass" in line]
    assert len(drifts) == steps + 1 and max(abs(d) for d in drifts) < 1e-12
    energy = lambda t: [line for line in t.splitlines() if "Integral of energy" in line]
    assert energy(log.getvalue())[0].split("=")[1].strip()[:10] == energy(jlog.getvalue())[0].split("=")[1].strip()[:10]


def _case5_rhs(**kw):
    geom, ops, metric, _, q0, topo = check.sw_topo_setup(NEL, S)
    return geom, ops, metric, q0, topo, kw


def test_perturbation_form_carries_topography():
    """The perturbation form around case 5's state with its topography:
    its RHS at the base is the base's absolute RHS with topography, a delta
    step equals the absolute stage with topography to rounding, and a base
    built without topography refuses the planes (and one built with them
    refuses a call without)."""
    geom, ops, metric, q0, topo, _ = _case5_rhs()
    rhs = make_rhs_shallow_water(geom, ops, metric, device="cpu", topo=topo, perturbation_base=q0)
    absolute = make_rhs_shallow_water(geom, ops, metric, device="cpu", topo=topo)
    q = torch.as_tensor(q0)
    torch.testing.assert_close(rhs(q), absolute(q), rtol=0, atol=1e-12 * float(absolute(q).abs().max()))
    con, topology, planes, x, y, _ = check.sw_topo_inputs(NEL, S, torch.float64, "cpu")
    base = swop.build_base_planes(q, con, topology, torch.float64, topo=planes)
    got = swop.sw_operator(y - base.q0, None, con, b=1.0, cdt=300.0, base=base, topology=topology, topo=planes)
    want = swop.sw_operator(y, None, con, b=1.0, cdt=300.0, topology=topology, topo=planes)
    assert _scaled((got + base.q0).numpy(), want.numpy()) < 1e-12
    flat = swop.build_base_planes(q, con, topology, torch.float64)
    with pytest.raises(ValueError, match="without topography"):
        swop.sw_operator(y - flat.q0, None, con, base=flat, topology=topology, topo=planes)
    with pytest.raises(ValueError, match="with topography"):
        swop.sw_operator(y - base.q0, None, con, base=base, topology=topology)
    with pytest.raises(ValueError, match="halo"):
        swop.sw_operator(y, swop.halo_from_traces(swop.edge_traces(y, con), topology), con, topo=planes)
    with pytest.raises(ValueError, match="traces"):
        swop.sw_operator(y, None, con, x=x, a=0.5, b=0.5, cdt=1.0, emit_traces=True, topology=topology, topo=planes)


def test_mixed_companion_carries_topography(tmp_path, capsys):
    """Case 5 with ``mixed_precision_krylov``: the float32 perturbation-form
    companion around the initial state with the case's topography, its base
    RHS the float64 operator's with topography, its J.v the absolute float32
    operator's with topography (the JAX rule), and no warning."""
    text = INI.format(case=5, dt=1800.0, t_end=1800.0, integrator="epi3", out=tmp_path)
    text = text.replace("exponential_solver = pmex", "exponential_solver = kiops_jit\nmixed_precision_krylov = 1")
    sim = Simulation(Configuration(text), device="cpu")
    assert "no effect" not in capsys.readouterr().out
    rhs32 = sim.rhs32
    assert rhs32.dtype == torch.float32 and rhs32.base.topography and rhs32.topo.dtype == torch.float32
    q = sim.initial_q
    torch.testing.assert_close(rhs32.base.rhs0, sim.rhs(q).float(), rtol=0, atol=0)
    v = 1e-3 * q * torch.sin(torch.arange(q.numel(), dtype=q.dtype).reshape(q.shape))
    want = sim.rhs.jtv(q, v)
    got = rhs32.jtv(q.float(), v.float()).double()
    assert _scaled(got.numpy(), want.numpy()) < 1e-4


def test_packed_run_refuses_topography():
    geom, ops, metric = j_geom(32, 4), j_ops(4), j_metric(j_geom(32, 4))
    q0, topo = j_case5(geom, ops)
    rhs = interop.shallow_water_rhs(geom, ops, metric, topo=topo)
    with pytest.raises(NotImplementedError, match="neither has the JAX package"):
        rhs.packed_run(torch.as_tensor(q0), 1, swop.tvdrk3_abc(10.0))


def test_tile_step_refuses_topography(tmp_path, monkeypatch):
    from wxfactory_tpu_torch import simulation

    monkeypatch.setattr(simulation._dist, "world_size", lambda: 6)
    monkeypatch.setattr(simulation._dist, "rank", lambda: 0)
    text = INI.format(case=5, dt=300.0, t_end=300.0, integrator="tvdrk3", out=tmp_path)
    with pytest.raises(NotImplementedError, match="the JAX package has none either"):
        Simulation(Configuration(text.replace("distribute = off", "distribute = shard_map")), device="cpu")
