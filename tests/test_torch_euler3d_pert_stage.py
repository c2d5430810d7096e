"""The port's float32 perturbation-form TVD-RK3 chain of 3D Euler
(``Euler3DRHS(perturbation_base=q0)``: ``stage`` on packed deltas with the
output's delta traces, ``pack``/``unpack``/``traces``, driven by
``Tvdrk3``) against the JAX package's ``make_rhs_euler_cubesphere(...,
interior="pallas", perturbation_base=q0)``: ``km3_fused(pert=, x=, cdt=,
stage_a=, stage_b=, emit_slabs=True)`` in Pallas interpret mode through
``packed_stage_chained`` and ``halo_from_slabs_delta``, stepped by the JAX
``Tvdrk3`` (its ``_PackedChain``), as tests/test_pallas_euler3d.py:119 and
:318 drive them.

Inputs from numpy seeds: dcmip31 with dq = 1e-4 q0 N(0,1) (and a second
such perturbation as the stage's x); errors per variable, scaled by the
reference's max.

* One stage (a = 0 and a != 0, float64, 3x2x2 s=2 and 2x2x4 s=4): the
  output delta within 1e-11 of the JAX kernel's; its emitted delta traces
  and their halos within 1e-11 of a fresh JAX-side delta extrapolation of
  the JAX output (``t0 * expm1(E.log1p(d/q0))``, exchanged by the JAX
  topology), which is what the JAX chain's emitted slabs hold (checked
  against ``edge_halo_delta`` of its output).
* Ten float64 TVD-RK3 steps at dt = 0.5 s against the JAX ``_PackedChain``
  within 1e-10; the mass of the absolute state drifts by round-off only.
* ``unpack(pack(q)) == q`` in float64 for q near q0 (Sterbenz: q - q0 is
  exact), to float32 rounding in float32.
* float32: the bench's accuracy gate (bench.py:640-656): at a 4-step
  float64 TVD-RK3 drift state the float32 perturbation RHS is within
  GATE_REL = 5e-3 of the float64 truth's tendency scale per variable and
  within twice the JAX CPU float32 perturbation form's error and below
  the float32 well-balanced absolute form's (all three printed); 25 float32
  TVD-RK3 steps of the chain beat the absolute float32 trajectory by at
  least 50 times against float64 (tests/test_euler3d.py:212-257).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.integrators import Tvdrk3 as JTvdrk3
from wxfactory_tpu.models.euler_cubesphere import make_rhs_euler_cubesphere as j_make_rhs
from wxfactory_tpu.ops import pallas_euler3d as pe3
from wxfactory_tpu.testcases.dcmip import dcmip_gravity_wave
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.integrators import Tvdrk3
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.output import global_mass_3d

torch.set_num_threads(1)

GATE_REL = 5e-3  # bench.py:309


def _setup(nel_h, nel_v, s):
    from conftest import cs3d_setup

    geom, ops, topo, metric = cs3d_setup(nel_h, nel_v, s, 10000.0)
    return geom, ops, topo, metric, dcmip_gravity_wave(geom)


@functools.lru_cache(maxsize=None)
def _jax_pert_kernel(nel_h, nel_v, s):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s)
    assert pe3.supported(s, nel_h, nel_v, 5, jnp.float64)
    rp = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="pallas", perturbation_base=q0)
    assert hasattr(rp, "packed_stage_chained")  # the km3_fused(pert=) route
    return rp


def _noise(q0, seed):
    return 1e-4 * q0 * np.random.default_rng(seed).standard_normal(q0.shape)


def _scaled_err(got, want):
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (want.ndim - 1))
    return float(np.abs((got - want) / scale).max())


def _port(geom, ops, metric, q0, dtype=torch.float64):
    return interop.euler3d_rhs(geom, ops, metric, dtype=dtype, perturbation_base=q0)


def _t(a, dtype=torch.float64):
    return interop.to_tensor(a, dtype=dtype)


def _fresh_delta_traces(d, q0, ops, topo):
    """JAX-side delta traces of the delta state ``d`` around ``q0``: the
    log-space rows as exp(E.log q0) * expm1(E.log1p(d/q0)), the momenta
    linear, pooled (S, N, W, E) and exchanged by the JAX topology. Returns
    (pool, halo), both (5, 4, 6, nk, nh, s^2)."""
    ss = ops.num_solpts**2
    ext = np.concatenate([ops.extrap_x3, ops.extrap_y3, ops.extrap_z3], axis=1)
    raw = np.concatenate([np.log1p(d[0:1] / q0[0:1]), d[1:4], np.log1p(d[4:5] / q0[4:5])]) @ ext
    t0 = np.concatenate([np.log(q0[0:1]), q0[1:4], np.log(q0[4:5])]) @ ext
    itf = np.concatenate([np.exp(t0[0:1]) * np.expm1(raw[0:1]), raw[1:4], np.exp(t0[4:5]) * np.expm1(raw[4:5])])
    itf_i, itf_j = itf[..., : 2 * ss], itf[..., 2 * ss : 4 * ss]
    pool = np.asarray(topo._trace_pool_3d(itf_i, itf_j))
    halo = np.asarray(topo.halo_state_3d(jnp.asarray(itf_i), jnp.asarray(itf_j), (1, 2)))
    return pool, halo


@pytest.mark.parametrize("a,b,c", [(0.0, 1.0, 1.0), (0.75, 0.25, 0.25)], ids=["a0", "a"])
@pytest.mark.parametrize("nel_h,nel_v,s", [(3, 2, 2), (2, 2, 4)], ids=["3x2x2", "2x2x4"])
def test_pert_stage_and_delta_halos_match_jax_km3_fused(nel_h, nel_v, s, a, b, c):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s)
    dq, dx = _noise(q0, 7), _noise(q0, 8)
    cdt = c * 0.5
    rp = _jax_pert_kernel(nel_h, nel_v, s)
    yp, xp = rp.pack_delta(jnp.asarray(dq)), rp.pack_delta(jnp.asarray(dx))
    out, slabs = rp.packed_stage_chained(xp, yp, rp.packed_slabs(yp), a, b, jnp.asarray(cdt))
    for got, fresh in zip(slabs, rp.packed_slabs(out)):  # the JAX chain's emitted delta halo
        np.testing.assert_allclose(np.asarray(got), np.asarray(fresh), rtol=1e-12, atol=1e-12 * np.abs(fresh).max())
    want = np.asarray(pe3.unpack_rows_jnp(out, nel_h, nel_v, s))

    rhs = _port(geom, ops, metric, q0)
    pool, halo = _fresh_delta_traces(want, q0, ops, topo)
    y, traces = rhs.stage(_t(dx), _t(dq), a, b, cdt)
    assert _scaled_err(y.numpy(), want) < 1e-11
    assert traces.shape == pool.shape
    assert _scaled_err(traces.numpy(), pool) < 1e-11
    assert _scaled_err(rhs.halo(traces).numpy(), halo) < 1e-11
    # The stage's traces are the bootstrap's of its output, to rounding.
    assert _scaled_err(traces.numpy(), rhs.traces(y).numpy()) < 1e-13


def test_pert_stage_plain_is_the_stage_combination():
    geom, ops, topo, metric, q0 = _setup(3, 2, 2)
    rhs = _port(geom, ops, metric, q0)
    dq, dx = _t(_noise(q0, 1)), _t(_noise(q0, 2))
    halo = rhs.halo(rhs.traces(dq))
    r = e3op.euler3d_operator(dq, halo, rhs.con, pert=rhs.pert)
    launches = (e3op.pert_launches, e3op.pert_stage_launches)
    y, traces = e3op.euler3d_operator(dq, halo, rhs.con, x=dx, a=1.0 / 3.0, b=2.0 / 3.0, cdt=0.2, emit_traces=True,
                                      pert=rhs.pert)
    assert (e3op.pert_launches, e3op.pert_stage_launches) == launches  # the plain version launches nothing
    torch.testing.assert_close(y, dx / 3.0 + (2.0 / 3.0) * dq + 0.2 * r, rtol=1e-14, atol=1e-14 * float(y.abs().max()))
    torch.testing.assert_close(traces, e3op.edge_traces_delta(y, rhs.pert, rhs.con), rtol=0, atol=0)


def test_ten_pert_tvdrk3_steps_match_jax_packed_chain():
    nel_h, nel_v, s, dt = 3, 2, 2, 0.5
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s)
    q = q0 + _noise(q0, 3)
    jint, jq = JTvdrk3(_jax_pert_kernel(nel_h, nel_v, s)), jnp.asarray(q)
    assert jint._packed is not None  # the JAX _PackedChain
    for _ in range(10):
        jq = jint.step(jq, dt)
    want = np.asarray(jq)

    rhs = _port(geom, ops, metric, q0)
    integ, qt = Tvdrk3(rhs), _t(q)
    packs = []
    pack = rhs.pack
    rhs.pack = lambda x: packs.append(1) or pack(x)
    for _ in range(10):
        qt = integ.step(qt, dt)
    assert len(packs) == 1  # the chain packs once and carries the delta
    assert _scaled_err(qt.numpy(), want) < 1e-10
    m0, m1 = global_mass_3d(q, ops, metric), global_mass_3d(qt.numpy(), ops, metric)
    assert abs(m1 - m0) < 1e-13 * abs(m0)


def test_pack_unpack_round_trip():
    geom, ops, topo, metric, q0 = _setup(3, 2, 2)
    q = _t(q0 + _noise(q0, 4))
    rhs = _port(geom, ops, metric, q0)
    assert torch.equal(rhs.unpack(rhs.pack(q)), q)
    torch.testing.assert_close(rhs.pack(q), q - _t(q0), rtol=0, atol=0)
    rhs32 = _port(geom, ops, metric, q0, torch.float32)
    dq32 = rhs32.pack(q)
    assert dq32.dtype == torch.float32 and dq32.is_contiguous()
    torch.testing.assert_close(rhs32.unpack(dq32), q.float(), rtol=2.0**-23, atol=0)
    absolute = interop.euler3d_rhs(geom, ops, metric)
    assert absolute.pack(q) is q and absolute.unpack(q) is q


def test_float32_pert_rhs_passes_the_bench_accuracy_gate():
    """bench.py:640-656 at its canonical 12x12x3, s=2: 4 float64 TVD-RK3
    steps of dt = 0.5 s from the initial state, then the float32 RHS
    against the float64 RHS there, per variable's tendency scale."""
    geom, ops, topo, metric, q0 = _setup(12, 3, 2)
    rhs64 = interop.euler3d_rhs(geom, ops, metric)
    q = _t(q0)
    for _ in range(4):
        q1 = q + 0.5 * rhs64(q)
        q2 = 0.75 * q + 0.25 * (q1 + 0.5 * rhs64(q1))
        q = q / 3.0 + 2.0 / 3.0 * (q2 + 0.5 * rhs64(q2))
    truth = rhs64(q).numpy()
    scale = np.abs(truth).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    err = lambda a: float(np.abs((np.asarray(a, np.float64) - truth) / scale).max())
    got = err(_port(geom, ops, metric, q0, torch.float32)(q.float()).numpy())
    jrp = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float32, interior="xla", perturbation_base=q0)
    ref = err(jax.jit(jrp)(jnp.asarray(q.numpy(), jnp.float32)))
    bal = err(interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32, base_state=q0)(q.float()).numpy())
    print(f"f32 RHS error at the drift state: perturbation {got:.3e}, JAX perturbation {ref:.3e}, bal {bal:.3e}")
    assert got < GATE_REL and got < 2.0 * ref, (got, ref)
    assert got < bal, (got, bal)  # the perturbation form beats the well-balanced absolute form


def test_float32_pert_chain_beats_absolute_float32():
    """25 TVD-RK3 steps at dt = 0.5 s on 8x3x2 through ``Tvdrk3``: the
    float32 perturbation chain (one stage launch a stage on the CPU's plain
    version) against the absolute float32 chain, both against float64;
    deviations scaled by the float64 trajectory's change per variable. The
    perturbation run is read as q0 + its carried float32 delta in float64
    (the chain's packed twin), as the JAX test reads q0 + qprime: the
    float32 absolute state it returns is rounded to float32 once more."""
    geom, ops, topo, metric, q0 = _setup(8, 3, 2)

    def run(rhs, dtype):
        integ, q = Tvdrk3(rhs), _t(q0, dtype)
        for _ in range(25):
            q = integ.step(q, 0.5)
        return integ._cache[1].double().numpy()

    truth = run(interop.euler3d_rhs(geom, ops, metric), torch.float64)
    dev = np.abs(truth - q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    err_abs = np.abs((run(interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32), torch.float32) - truth)
                     / dev).max()
    err_pert = np.abs((q0 + run(_port(geom, ops, metric, q0, torch.float32), torch.float32) - truth) / dev).max()
    assert err_pert < err_abs / 50.0, (err_pert, err_abs)
