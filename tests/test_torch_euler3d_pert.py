"""The port's perturbation (base-state-split) form of the 3D Euler operator
(``Euler3DRHS(perturbation_base=q0)``: ``euler3d_operator_pert_plain`` and
its tangent ``euler3d_tangent_pert_plain`` on the CPU) against the JAX
package's ``make_rhs_euler_cubesphere(..., perturbation_base=q0)``.

Inputs as the JAX package's tests make them, from numpy seeds: dcmip31
(or the rotating planet of case 77), q = q0 + dq with dq = 1e-4 q0 N(0,1)
and a direction v = 1e-3 max|q0| N(0,1) per variable. Errors are per
variable, scaled by the reference output's max.

* RHS mode: at q0 the perturbation form reproduces the port's absolute
  RHS within 1e-13 (rhs0 + 0); ``.delta(dq)`` is within 1e-11 of the JAX
  XLA ``rhs_pert.delta`` and of ``km3_fused(pert=)`` in interpret mode
  (``interior="pallas"``, as tests/test_pallas_euler3d.py:318-345); near
  q0 the form is within 1e-11 of the port's absolute RHS.
* Tangent mode: J(q0 + dq).v within 1e-11 of ``jax.jvp(rp_xla.delta)`` and
  of ``rhs_packed_pure(pert=, tangent_qp=)``, the pure-jnp loop over the TPU
  kernel's body; its mass integral vanishes to 1e-12 of the absolute one.
* float32: the tangent within 5e-5 of the float64 one and within 10 times
  the JAX float32 XLA jvp's error (tests/test_pallas_euler3d.py:277-315);
  25 TVD-RK3 steps of the carried float32 perturbation beat the absolute
  float32 trajectory by at least 50 times against the float64 truth
  (tests/test_euler3d.py:212-257).

The JAX package writes log1p/expm1 as compensated formulas; the port's plain
version uses torch's, ~1 ulp of the small arguments, far below these bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.models.euler_cubesphere import make_rhs_euler_cubesphere as j_make_rhs
from wxfactory_tpu.ops import pallas_euler3d as pe3
from wxfactory_tpu.testcases.dcmip import acoustic_wave, dcmip_gravity_wave
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.output import global_mass_3d

torch.set_num_threads(1)


def _setup(nel_h, nel_v, s, case=31):
    from conftest import cs3d_setup

    scale, rotating = (125.0, False) if case == 31 else (1.0, True)
    geom, ops, topo, metric = cs3d_setup(nel_h, nel_v, s, 10000.0, scale=scale, rotating=rotating)
    q0 = (dcmip_gravity_wave if case == 31 else acoustic_wave)(geom)
    return geom, ops, topo, metric, q0


def _inputs(q0, seed=7):
    rng = np.random.default_rng(seed)
    dq = 1e-4 * q0 * rng.standard_normal(q0.shape)
    v = rng.standard_normal(q0.shape) * np.abs(q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1) * 1e-3
    return dq, v


def _scaled_err(got, want):
    scale = np.abs(want).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    return float(np.abs((got - want) / scale).max())


def _port(geom, ops, metric, q0, dtype=torch.float64):
    return interop.euler3d_rhs(geom, ops, metric, dtype=dtype, perturbation_base=q0)


def _t(a, dtype=torch.float64):
    return interop.to_tensor(a, dtype=dtype)


@pytest.mark.parametrize("nel_h,nel_v,s", [(4, 2, 3), (3, 2, 2)], ids=["4x2x3", "3x2x2"])
def test_pert_rhs_at_and_near_the_base_matches_absolute(nel_h, nel_v, s):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s)
    rhs = _port(geom, ops, metric, q0)
    absolute = interop.euler3d_rhs(geom, ops, metric)
    assert _scaled_err(rhs(_t(q0)).numpy(), absolute(_t(q0)).numpy()) < 1e-13
    qp = q0 * (1.0 + 1e-3 * np.random.default_rng(0).standard_normal(q0.shape))
    assert _scaled_err(rhs(_t(qp)).numpy(), absolute(_t(qp)).numpy()) < 1e-11


@pytest.mark.parametrize("nel_h,nel_v,s", [(4, 2, 3), (3, 2, 2)], ids=["4x2x3", "3x2x2"])
def test_pert_delta_matches_jax_xla(nel_h, nel_v, s):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s)
    dq, _ = _inputs(q0)
    rp = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla", perturbation_base=q0)
    want = np.asarray(jax.jit(rp.delta)(jnp.asarray(dq)))
    assert _scaled_err(_port(geom, ops, metric, q0).delta(_t(dq)).numpy(), want) < 1e-11


@pytest.mark.parametrize("nel_h,nel_v,s,case", [(4, 2, 2, 31), (4, 2, 3, 31), (4, 2, 3, 77)],
                         ids=["4x2x2", "4x2x3", "rotating-4x2x3"])
def test_pert_delta_matches_tpu_kernel_interpret(nel_h, nel_v, s, case):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s, case)
    dq, _ = _inputs(q0)
    assert pe3.supported(s, nel_h, nel_v, 5, jnp.float64)
    rp_k = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="pallas", perturbation_base=q0)
    assert hasattr(rp_k, "packed_stage_chained")  # the km3_fused(pert=) route
    want = np.asarray(rp_k.delta(jnp.asarray(dq)))
    assert _scaled_err(_port(geom, ops, metric, q0).delta(_t(dq)).numpy(), want) < 1e-11


@pytest.mark.parametrize("nel_h,nel_v,s,case", [(4, 2, 3, 31), (3, 2, 2, 31), (4, 2, 3, 77)],
                         ids=["4x2x3", "3x2x2", "rotating-4x2x3"])
def test_pert_tangent_matches_jax_jvp(nel_h, nel_v, s, case):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s, case)
    dq, v = _inputs(q0)
    rp = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla", perturbation_base=q0)
    want = np.asarray(jax.jit(lambda a, b: jax.jvp(rp.delta, (a,), (b,))[1])(jnp.asarray(dq), jnp.asarray(v)))
    rhs = _port(geom, ops, metric, q0)
    plain = e3op.plain_tangent_calls
    got = rhs.jtv(_t(q0 + dq), _t(v)).numpy()
    assert e3op.plain_tangent_calls == plain + 1
    assert _scaled_err(got, want) < 1e-11


@pytest.mark.parametrize("nel_h,nel_v,s", [(4, 2, 3), (3, 2, 2)], ids=["4x2x3", "3x2x2"])
def test_pert_tangent_matches_tpu_kernel_body(nel_h, nel_v, s):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s)
    dq, v = _inputs(q0)
    con = pe3.build_constants(ops, metric, nel_h, nel_v, s, dtype=jnp.float64)
    hops = pe3.build_halo_ops(ops, topo, s, dtype=jnp.float64)
    _g, ty, _rp = pe3.grid_plan(s, nel_h, nel_v)
    rhs64 = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla")
    q0j = jnp.asarray(q0)
    pbase = pe3.build_pert_base(q0j, rhs64(q0j), topo, ops, nel_h, nel_v, ty, s, jnp.float64)
    out = pe3.rhs_packed_pure(pe3.pack_rows_jnp(jnp.asarray(dq), nel_h, nel_v, s), con, topo, hops, nel_h, nel_v,
                              ty, s, pert=pbase, tangent_qp=pe3.pack_rows_jnp(jnp.asarray(v), nel_h, nel_v, s))
    want = np.asarray(pe3.unpack_rows_jnp(out, nel_h, nel_v, s))
    got = _port(geom, ops, metric, q0).jtv(_t(q0 + dq), _t(v)).numpy()
    assert _scaled_err(got, want) < 1e-11


def test_pert_tangent_conserves_mass():
    geom, ops, topo, metric, q0 = _setup(4, 2, 3)
    dq, v = _inputs(q0)
    jv = _port(geom, ops, metric, q0).jtv(_t(q0 + dq), _t(v)).numpy()
    assert abs(global_mass_3d(jv, ops, metric)) < 1e-12 * global_mass_3d(np.abs(jv), ops, metric)


def test_pert_wrappers_check_inputs():
    geom, ops, topo, metric, q0 = _setup(3, 2, 2)
    dq, v = _inputs(q0)
    rhs = _port(geom, ops, metric, q0)
    d = _t(dq)
    halo = rhs.halo(e3op.edge_traces_delta(d, rhs.pert, rhs.con))
    # The stage and the delta traces run with pert (the stage mode of the
    # perturbation form); the well-balanced offset does not.
    y = e3op.euler3d_operator(d, halo, rhs.con, cdt=1.0, pert=rhs.pert)
    assert y.shape == d.shape
    _, traces = e3op.euler3d_operator(d, halo, rhs.con, emit_traces=True, pert=rhs.pert)
    assert traces.shape == rhs.con.traces_shape
    with pytest.raises(ValueError, match="no well-balanced offset"):
        e3op.euler3d_operator(d, halo, rhs.con, bal=d, pert=rhs.pert)
    with pytest.raises(ValueError):
        e3op.euler3d_operator(d.float(), halo, rhs.con, pert=rhs.pert)  # dtype differs from the constants
    with pytest.raises(ValueError, match="5-variable"):
        interop.euler3d_rhs(geom, ops, metric, perturbation_base=q0[:4])
    out, out_traces = rhs.stage(d, d, 0.0, 1.0, 1.0)
    assert out.shape == d.shape and out_traces.shape == rhs.con.traces_shape


def test_float32_pert_tangent_accuracy():
    geom, ops, topo, metric, q0 = _setup(4, 2, 3)
    dq, v = _inputs(q0, seed=11)
    truth = _port(geom, ops, metric, q0).jtv(_t(q0 + dq), _t(v)).numpy()
    got = _port(geom, ops, metric, q0, torch.float32).jtv(_t(q0 + dq), _t(v, torch.float32)).numpy()
    assert got.dtype == np.float32
    rp32 = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float32, interior="xla", perturbation_base=q0)
    jvp32 = jax.jit(lambda a, b: jax.jvp(rp32.delta, (a,), (b,))[1])
    ref32 = np.asarray(jvp32(jnp.asarray(dq, jnp.float32), jnp.asarray(v, jnp.float32)))
    err, err_ref = _scaled_err(got.astype(np.float64), truth), _scaled_err(ref32.astype(np.float64), truth)
    assert err < 5e-5, err
    assert err < max(10 * err_ref, 1e-5), (err, err_ref)


def test_float32_carried_perturbation_beats_absolute_float32():
    """25 TVD-RK3 steps at dt = 0.5 s on 8x3x2: the float32 trajectory of
    the carried perturbation (``.delta``) against the absolute float32 one,
    both against float64; deviations scaled by the float64 trajectory's
    change per variable."""
    geom, ops, topo, metric, q0 = _setup(8, 3, 2)
    rhs64 = interop.euler3d_rhs(geom, ops, metric)
    rhs32 = interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32)
    delta32 = _port(geom, ops, metric, q0, torch.float32).delta

    def run(rhs, q, dt=0.5, n=25):
        for _ in range(n):
            q1 = q + rhs(q) * dt
            q2 = 0.75 * q + 0.25 * (q1 + rhs(q1) * dt)
            q = q / 3.0 + 2.0 / 3.0 * (q2 + rhs(q2) * dt)
        return q

    truth = run(rhs64, _t(q0)).numpy()
    dev = np.abs(truth - q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    err_abs = np.abs((run(rhs32, _t(q0, torch.float32)).double().numpy() - truth) / dev).max()
    qprime = run(delta32, torch.zeros(q0.shape, dtype=torch.float32)).double().numpy()
    err_pert = np.abs((q0 + qprime - truth) / dev).max()
    assert err_pert < err_abs / 50.0, (err_pert, err_abs)
