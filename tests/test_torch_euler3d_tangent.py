"""The port's Jacobian action J(q).v of the 3D Euler operator
(``wxfactory_tpu_torch.ops.euler3d_operator.euler3d_tangent``: the plain
``torch.func.jvp`` version on the CPU) against the JAX package, float64.

Inputs as the JAX package's test_tangent_kernel_matches_jvp makes them
(tests/test_pallas_euler3d.py:238-244), from a numpy seed: q = q0 + dq with
dq = 1e-4 q0 N(0,1), v = 1e-3 max|q0| N(0,1) per variable. Bound: 1e-11 of
each variable's max of the JAX J.v, the bound of that test.

* (a) ``jax.jvp`` of the XLA RHS of the same geometry at q0 + dq, at
  (4,2,3), (3,2,2) and the rotating planet of case 77 (time Christoffels);
  and at the unperturbed state at rest (w = 0 on every z face) in a
  direction with a w component, where the derivative of |w| at 0 decides
  the answer (the port takes jax.jvp's +dw, see ``_abs``).
* (b) ``rhs_packed_pure(..., pert=pbase, tangent_qp=vp)``, the pure-jnp
  block loop over the TPU kernel's body in tangent mode, at (4,2,3) and (3,2,2),
  unpacked. (Its v has no w component at w = 0, where the TPU body's
  sign(0) = 0 and jax.jvp's +1 would differ.)
* The plain J.v's mass integral vanishes: |int sqrt(g) (J.v)_rho| < 1e-12
  of int sqrt(g) |(J.v)_rho|.
* The float32 plain J.v is within 5e-5 of the float64 one's scale, the
  bound of the JAX test_tangent_kernel_f32_accuracy.
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
from wxfactory_tpu_torch.models import Euler3DRHS, ShallowWaterRHS, make_rhs_shallow_water
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


def _jax_jvp(geom, ops, topo, metric, q, v):
    """jax.jvp of the XLA RHS, jitted (eager jvp dispatches op by op)."""
    rhs = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla")
    return np.asarray(jax.jit(lambda a, b: jax.jvp(rhs, (a,), (b,))[1])(jnp.asarray(q), jnp.asarray(v)))


def _port_jtv(geom, ops, metric, q, v, dtype=torch.float64):
    rhs = interop.euler3d_rhs(geom, ops, metric, dtype=dtype)
    return interop.to_numpy(rhs.jtv(interop.to_tensor(q, dtype=dtype), interop.to_tensor(v, dtype=dtype)))


@pytest.mark.parametrize("nel_h,nel_v,s,case", [(4, 2, 3, 31), (3, 2, 2, 31), (4, 2, 3, 77)],
                         ids=["4x2x3", "3x2x2", "rotating-4x2x3"])
def test_plain_tangent_matches_jax_jvp(nel_h, nel_v, s, case):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s, case)
    dq, v = _inputs(q0)
    if case == 77:  # the acoustic wave starts at rest: give the direction's w a scale of its own
        v[3] = np.random.default_rng(8).standard_normal(q0[3].shape) * 1e-3 * np.abs(q0[0]).max()
    want = _jax_jvp(geom, ops, topo, metric, q0 + dq, v)
    got = _port_jtv(geom, ops, metric, q0 + dq, v)
    assert _scaled_err(got, want) < 1e-11


def test_plain_tangent_at_rest_takes_jax_derivative_of_abs(monkeypatch):
    """At rest (w = 0 on every z face; dq leaves rho*w at 0) the Rusanov
    speed |w|/rho + c is differentiated at |0|: jax.jvp takes +dw there,
    torch's abs 0, which leaves J.v more than 1e-4 of scale away. dq is
    kept: at the unperturbed, mirror-symmetric state max(aL, aR) ties at the
    equator faces to the rounding of each implementation, where the one-sided
    derivatives differ."""
    geom, ops, topo, metric, q0 = _setup(4, 2, 3)
    dq, v = _inputs(q0)
    assert not np.any(q0[3] + dq[3])
    v[3] = np.random.default_rng(9).standard_normal(q0[3].shape) * 1e-3 * np.abs(q0[0]).max()
    want = _jax_jvp(geom, ops, topo, metric, q0 + dq, v)
    assert _scaled_err(_port_jtv(geom, ops, metric, q0 + dq, v), want) < 1e-11
    monkeypatch.setattr(e3op, "_abs", torch.abs)
    assert _scaled_err(_port_jtv(geom, ops, metric, q0 + dq, v), want) > 1e-4


@pytest.mark.parametrize("nel_h,nel_v,s", [(4, 2, 3), (3, 2, 2)], ids=["4x2x3", "3x2x2"])
def test_plain_tangent_matches_tpu_kernel_body(nel_h, nel_v, s):
    geom, ops, topo, metric, q0 = _setup(nel_h, nel_v, s)
    dq, v = _inputs(q0)
    assert pe3.supported(s, nel_h, nel_v, 5, jnp.float64)
    con = pe3.build_constants(ops, metric, nel_h, nel_v, s, dtype=jnp.float64)
    hops = pe3.build_halo_ops(ops, topo, s, dtype=jnp.float64)
    _g, ty, _rp = pe3.grid_plan(s, nel_h, nel_v)
    rhs64 = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla")
    q0j = jnp.asarray(q0)
    pbase = pe3.build_pert_base(q0j, rhs64(q0j), topo, ops, nel_h, nel_v, ty, s, jnp.float64)
    out = pe3.rhs_packed_pure(pe3.pack_rows_jnp(jnp.asarray(dq), nel_h, nel_v, s), con, topo, hops, nel_h, nel_v,
                              ty, s, pert=pbase, tangent_qp=pe3.pack_rows_jnp(jnp.asarray(v), nel_h, nel_v, s))
    want = np.asarray(pe3.unpack_rows_jnp(out, nel_h, nel_v, s))
    assert _scaled_err(_port_jtv(geom, ops, metric, q0 + dq, v), want) < 1e-11


def test_plain_tangent_conserves_mass():
    geom, ops, topo, metric, q0 = _setup(4, 2, 3)
    dq, v = _inputs(q0)
    jv = _port_jtv(geom, ops, metric, q0 + dq, v)
    total = global_mass_3d(jv, ops, metric)
    assert abs(total) < 1e-12 * global_mass_3d(np.abs(jv), ops, metric)


def test_float32_plain_tangent_is_within_f32_bound():
    geom, ops, topo, metric, q0 = _setup(4, 2, 3)
    dq, v = _inputs(q0, seed=11)
    truth = _port_jtv(geom, ops, metric, q0 + dq, v)
    got = _port_jtv(geom, ops, metric, q0 + dq, v, dtype=torch.float32)
    assert got.dtype == np.float32
    assert _scaled_err(got.astype(np.float64), truth) < 5e-5


def test_float32_error_comes_from_round_off_level_normal_speeds():
    """dq = 1e-4 q0 N(0,1) leaves rho*u2 at round-off level at the equator
    faces of the symmetric dcmip31 state, where d|vn| flips with the sign
    of vn: there the float32 J.v lands more than 5e-5 of scale from the
    float64 one. With the noise scaled by each variable's max instead it is
    within 5e-6."""
    geom, ops, topo, metric, q0 = _setup(4, 2, 3)
    scale = np.abs(q0).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    errs = []
    for dq_scale in (q0, scale):
        rng = np.random.default_rng(7)
        dq = 1e-4 * dq_scale * rng.standard_normal(q0.shape)
        v = rng.standard_normal(q0.shape) * scale * 1e-3
        truth = _port_jtv(geom, ops, metric, q0 + dq, v)
        got = _port_jtv(geom, ops, metric, q0 + dq, v, dtype=torch.float32)
        errs.append(_scaled_err(got.astype(np.float64), truth))
    assert errs[0] > 5e-5 and errs[1] < 5e-6, errs


def test_tangent_glue_is_the_derivative_of_the_primal_glue():
    geom, ops, topo, metric, q0 = _setup(3, 2, 3)
    dq, v = _inputs(q0)
    v[3] = v[1]  # a w component, so that every halo row has a scale
    rhs = interop.euler3d_rhs(geom, ops, metric)
    q, vt = interop.to_tensor(q0 + dq), interop.to_tensor(v)
    want = torch.func.jvp(lambda x: rhs.halo(rhs.traces(x)), (q,), (vt,))[1]
    got = rhs.halo(e3op.edge_traces_tangent(q, vt, rhs.con))
    assert _scaled_err(got.numpy(), want.numpy()) < 1e-14


def test_tangent_wrapper_checks_inputs_and_counts_plain_calls():
    geom, ops, topo, metric, q0 = _setup(3, 2, 2)
    dq, v = _inputs(q0)
    rhs = interop.euler3d_rhs(geom, ops, metric)
    q, vt = interop.to_tensor(q0 + dq), interop.to_tensor(v)
    _, _, traces, halo_q, _ = rhs.jtv_prep(q)
    halo_v = rhs.halo(e3op.edge_traces_tangent(q, vt, rhs.con, traces))
    launches, plain = e3op.tangent_launches, e3op.plain_tangent_calls
    out = e3op.euler3d_tangent(q, vt, halo_q, halo_v, rhs.con)
    assert e3op.tangent_launches == launches  # the CPU runs the plain version: no launch
    assert e3op.plain_tangent_calls == plain + 1
    want = torch.func.jvp(rhs, (q,), (vt,))[1]  # the whole RHS, glue included
    assert _scaled_err(out.numpy(), want.numpy()) < 1e-13
    with pytest.raises(ValueError):
        e3op.euler3d_tangent(q, vt.float(), halo_q, halo_v, rhs.con)  # dtype differs from the constants
    with pytest.raises(ValueError):
        e3op.euler3d_tangent(q, vt[:, :, :1].contiguous(), halo_q, halo_v, rhs.con)  # wrong shape
    with pytest.raises(ValueError):
        e3op.euler3d_tangent(q, vt, halo_q, halo_v.transpose(3, 4), rhs.con)  # not contiguous


@pytest.mark.parametrize("make", [Euler3DRHS, ShallowWaterRHS, make_rhs_shallow_water],
                         ids=["Euler3DRHS", "ShallowWaterRHS", "make_rhs_shallow_water"])
def test_model_entry_points_default_to_the_card(make, monkeypatch):
    """Without a device argument an RHS runs on the card; on a machine
    without one it raises instead of running on the CPU."""
    from conftest import cs2d_setup, cs3d_setup

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    geom, ops, _topo, metric = cs3d_setup(2, 1, 2) if make is Euler3DRHS else cs2d_setup(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(geom, ops, metric)
