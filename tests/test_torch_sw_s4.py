"""The port's s=4 shallow-water route against the JAX package's
(ops/pallas_sw.py), on the CPU, where the wrappers run the plain torch
versions; the JAX Pallas kernels run in interpret mode.

* The halo exchange (``halo_from_traces``, plain version of the halo
  kernel) against ``kh_exchange`` at nel=32 (npts = 128, its gate), within
  1e-14 of scale: a permutation, edge flips and one 2x2 rotation.
* The panel-edge traces (``edge_traces``, plain version of the edge-trace
  kernel) against ``ke_edges`` at nel=16, mapped out of its slab layout,
  within 1e-14.
* ``km_fused``: the operator the port runs at every s (``sw_operator``)
  computes its function at s=4 — stages against ``packed_stage`` in
  interpret mode at rtol 1e-12; the perturbation mode against ``km_fused``
  with base planes is in tests/test_torch_sw_pert.py.
* ``packed_run`` (plain version of the whole-run kernel) against the JAX
  ``rhs.packed_run`` (``kr_run``) at nel=32: absolute, 2 steps; perturbation
  form, 1 step, after unpack; rtol 1e-13, atol 1e-10 (tests/test_pallas.py:
  158-183). ``packed_run`` exists where the JAX package's does and nowhere
  else.
* An INI with ``precision = float32``, ``num_solpts = 4``, nel=32 through
  ``python -m wxfactory_tpu_torch --device cpu`` against the JAX
  ``Simulation`` of the same INI (its XLA interior off a TPU), within 1e-5
  of each variable's max after 5 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.config import Configuration as JConfiguration
from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops import pallas_sw
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.output.state import load_state as j_load_state
from wxfactory_tpu.parallel.topology import CubedSphereTopology as JTopology
from wxfactory_tpu.simulation import Simulation as JSimulation
from wxfactory_tpu.testcases import williamson_case6
from wxfactory_tpu_torch import __main__ as cli
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.kernels.check import sw_delta
from wxfactory_tpu_torch.ops import sw_operator as swop
from wxfactory_tpu_torch.parallel.topology import CubedSphereTopology

torch.set_num_threads(1)

S = 4


def _setup(nel):
    geom = make_cubed_sphere_2d(nel, S)
    ops = make_dfr_operators(S)
    metric = make_metric_2d(geom)
    return geom, ops, metric, williamson_case6(geom)


def _scale(a, nvar=3):
    return np.abs(a).reshape(nvar, -1).max(axis=1).reshape((nvar,) + (1,) * (a.ndim - 1))


def test_halo_matches_jax_kh_exchange():
    nel = 32
    geom = make_cubed_sphere_2d(nel, S)
    npts = nel * S
    pool = np.random.default_rng(7).standard_normal((3, 4, 6, npts))
    hc = pallas_sw.build_halo_constants(JTopology(geom), dtype=jnp.float64)
    hwe, hs, hn = (np.asarray(a) for a in pallas_sw.kh_exchange(jnp.asarray(pool), hc, interpret=True))
    want = np.stack([hs[:, :, 0, :npts], hn[:, :, 0, :npts],
                     np.moveaxis(hwe[:, :, 0], 0, 1), np.moveaxis(hwe[:, :, 1], 0, 1)], axis=1)
    traces = interop.to_tensor(pool.reshape(3, 4, 6, nel, S))
    got = interop.to_numpy(swop.sw_halo(traces, CubedSphereTopology(geom))).reshape(3, 4, 6, npts)
    assert np.abs((got - want) / _scale(want)).max() < 1e-14


def test_edge_traces_match_jax_ke_edges():
    nel = 16
    geom, ops, metric, q = _setup(nel)
    q = q * (1.0 + 1e-3 * np.random.default_rng(3).standard_normal(q.shape))
    jr = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="pallas")
    we, sv, nv = (np.asarray(a) for a in jr.packed_slabs(jr.pack(jnp.asarray(q))))
    rpr = nel // 8
    rpad = -(-rpr // 8) * 8
    # Slab layout (pallas_sw.ke_edges): we row p*nel + y holds the west face at
    # lanes 0..s-1 and the east face at 64-s..63; s/n hold each panel's first
    # and last rpad trace rows, element ex at row ex // 8 of the edge, y-face
    # lanes 64 + 8 (ex % 8) + (0 south | 4 north) + k.
    ex = np.arange(nel)
    lanes = 64 + 8 * (ex % 8)[:, None] + np.arange(S)[None, :]
    want = np.empty((3, 4, 6, nel, S))
    for p in range(6):
        want[:, 0, p] = sv[:, p * rpad + ex // 8][:, np.arange(nel)[:, None], lanes]
        want[:, 1, p] = nv[:, p * rpad + (rpad - rpr) + ex // 8][:, np.arange(nel)[:, None], lanes + 4]
        want[:, 2, p] = we[:, p * nel : (p + 1) * nel, :S]
        want[:, 3, p] = we[:, p * nel : (p + 1) * nel, 64 - S : 64]
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    got = interop.to_numpy(swop.sw_edges(interop.to_tensor(q), rhs.con))
    assert np.abs((got - want) / _scale(want)).max() < 1e-14


@pytest.mark.parametrize("a,b,c", [(0.0, 1.0, 1.0), (0.75, 0.25, 0.25)], ids=["no-x", "with-x"])
def test_stage_matches_jax_km_fused(a, b, c):
    nel, dt = 16, 30.0
    geom, ops, metric, q = _setup(nel)
    y = q * (1.0 + 1e-3 * np.random.default_rng(5).standard_normal(q.shape))
    jr = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="pallas")
    qp, yp = jr.pack(jnp.asarray(q)), jr.pack(jnp.asarray(y))
    want = np.asarray(jr.unpack(jr.packed_stage(qp, yp, a, b, jnp.asarray(c * dt)))).reshape(q.shape)
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    got, _ = rhs.stage(interop.to_tensor(q), interop.to_tensor(y), a, b, c * dt)
    got = interop.to_numpy(got)
    for v in range(3):
        np.testing.assert_allclose(got[v], want[v], rtol=1e-12, atol=1e-12 * np.abs(want[v]).max())


@pytest.mark.parametrize("pert,nsteps", [(False, 2), (True, 1)], ids=["absolute-2", "perturbation-1"])
def test_packed_run_matches_jax_kr_run(pert, nsteps):
    nel, dt = 32, 30.0
    geom, ops, metric, q0 = _setup(nel)
    base = jnp.asarray(q0) if pert else None
    jr = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="pallas", perturbation_base=base)
    assert hasattr(jr, "packed_run"), "the JAX whole-run path should be active at nel=32, s=4"
    q = q0 + sw_delta(q0) if pert else q0
    want = np.asarray(jr.unpack(jr.packed_run(jr.pack(jnp.asarray(q)), nsteps,
                                               pallas_sw.tvdrk3_abc(jnp.asarray(dt))))).reshape(q0.shape)

    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=q0 if pert else None)
    out = rhs.packed_run(rhs.pack(interop.to_tensor(q)), nsteps, swop.tvdrk3_abc(dt))
    got = interop.to_numpy(rhs.unpack(out))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-10)


def test_packed_run_is_exposed_where_the_jax_package_exposes_it():
    for nel, s, expose in ((32, 4, True), (16, 4, False), (32, 3, False)):
        geom = make_cubed_sphere_2d(nel, s)
        rhs = interop.shallow_water_rhs(geom, make_dfr_operators(s), make_metric_2d(geom))
        assert hasattr(rhs, "packed_run") == expose == swop.run_supported(s, nel)


INI = """
[General]
equations = shallow_water
[System]
precision = float32
distribute = off
[Test_case]
case_number = 6
[Time_integration]
dt = 30
t_end = 150
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 4
num_elements_horizontal = 32
[Grid]
grid_type = cubed_sphere
[Output_options]
save_state_freq = 5
stat_freq = 5
output_dir = {out}
"""


def test_f32_s4_cli_run_matches_jax_simulation(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jsim = JSimulation(JConfiguration(INI.format(out=jdir)))
    jsim.run()
    ini = tmp_path / "case6_f32_s4.ini"
    ini.write_text(INI.format(out=tdir))
    assert cli.main([str(ini), "--device", "cpu"]) == 0
    want, _, _ = j_load_state(jsim.output.state_file_name(5))
    paths = list(tdir.glob("state_vector_*.00000005.npy"))
    assert len(paths) == 1
    got, config, _ = j_load_state(str(paths[0]))
    assert got.shape == want.shape == (3, 6, 32, 32, 16) and got.dtype == want.dtype == np.float32
    got, want = got.astype(np.float64), want.astype(np.float64)
    assert np.abs((got - want) / _scale(want)).max() < 1e-5
