"""The port's 3D Euler operator (wxfactory_tpu_torch.ops.euler3d_operator)
against the JAX package, float64 on the CPU, where the wrapper runs the
plain torch version.

* RHS mode against ``make_rhs_euler_cubesphere(interior="xla")``: 5e-11 of
  scale, the bound of the JAX package's test_generic_shapes_match_xla. The
  port keeps one panel's copy of the metric (the six agree to ~5e-13 of
  scale, as the JAX kernel's build_constants also assumes) and sums in
  another order. Checked at s = 2..6 at a noisy DCMIP 31 state, where the
  scale is each variable's max, at the balanced one, and at a noisy case-77
  state on the rotating planet (case 77 at rest has no flux term to scale
  its dissipation-only rho and rho*theta rows by). The balanced state's RHS is a residual 1e2-1e5 times
  smaller than the terms that cancel in it (zonal mass flux, hydrostatic
  balance), so max-scaling it measures round-off of those terms (1e-10 at
  4x4x4, as the JAX kernel's own 1e-9 bound against XLA at this state,
  tests/test_pallas_euler3d.py:62, allows); there the scale is the larger
  of the RHS max and the term scale of kernels/check.py (flux divergence;
  gravity for rho*w), the size of what cancels, as the shallow-water tests
  do for case 2.
* Stage mode and the emitted traces against the JAX ``km3_fused`` kernel
  run in Pallas interpret mode, driven as tests/test_pallas_euler3d.py:
  83-158 drives it, unpacked through the JAX pipeline: 1e-12 of each
  variable's max.
* float32 with the well-balanced offset, against the JAX float32
  ``base_state`` RHS: at the base state both are within 1e-2 of the f64 RHS
  (per variable max) and 1e3 times closer than without the offset (the
  bounds of test_balanced_offset_restores_base_state_rhs); the port and JAX
  agree to 1e-5 of the f64 RHS max (float32 round-off of the f64 RHS both
  restore).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry.cubed_sphere_3d import make_cubed_sphere_3d
from wxfactory_tpu.geometry.metric3d import make_metric_3d
from wxfactory_tpu.models.euler_cubesphere import make_rhs_euler_cubesphere as j_make_rhs
from wxfactory_tpu.ops import pallas_euler3d as pe3
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.parallel.topology import CubedSphereTopology as JTopology
from wxfactory_tpu.testcases.dcmip import acoustic_wave, dcmip_gravity_wave
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.kernels.check import euler3d_term_scale
from wxfactory_tpu_torch.ops import euler3d_operator as e3op

torch.set_num_threads(1)


def _setup(nel_h, nel_v, s, case=31):
    scale, rotating = (125.0, False) if case == 31 else (1.0, True)
    geom = make_cubed_sphere_3d(nel_h, nel_v, s, 10000.0, planet_scaling_factor=scale,
                                planet_is_rotating=rotating)
    ops = make_dfr_operators(s, three_d=True)
    topo = JTopology(geom)
    metric = make_metric_3d(geom, ops, topo)
    q = (dcmip_gravity_wave if case == 31 else acoustic_wave)(geom)
    return geom, ops, topo, metric, q


def _noisy(q, seed=0):
    rng = np.random.default_rng(seed)
    out = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
    out[3] += 0.1 * q[0] * rng.standard_normal(q[0].shape)
    return out


def _scaled_err(got, want, floor=None):
    scale = np.abs(want).reshape(5, -1).max(axis=1)
    if floor is not None:
        scale = np.maximum(scale, floor)
    return float(np.abs((got - want) / scale.reshape((5,) + (1,) * (want.ndim - 1))).max())


XLA_SHAPES = [(12, 3, 2, 31), (6, 4, 3, 31), (4, 4, 4, 31), (2, 2, 5, 31), (2, 2, 6, 31)]
XLA_IDS = ["12x3x2", "6x4x3", "4x4x4", "2x2x5", "2x2x6"]


@pytest.mark.parametrize(
    "nel_h,nel_v,s,case,noisy",
    [shape + (False,) for shape in XLA_SHAPES] + [shape + (True,) for shape in XLA_SHAPES + [(4, 2, 3, 77)]],
    ids=[f"{i}-balanced" for i in XLA_IDS] + [f"{i}-noisy" for i in XLA_IDS + ["rotating-4x2x3"]],
)
def test_plain_rhs_matches_jax_xla(nel_h, nel_v, s, case, noisy):
    geom, ops, topo, metric, q = _setup(nel_h, nel_v, s, case)
    if noisy:
        q = _noisy(q)
    want = np.asarray(j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla")(jnp.asarray(q)))
    rhs = interop.euler3d_rhs(geom, ops, metric)
    assert (rhs.con.tch is not None) == (case == 77)
    qt = interop.to_tensor(q)
    got = interop.to_numpy(rhs(qt))
    assert got.shape == want.shape
    floor = None if noisy else euler3d_term_scale(qt, rhs.con).numpy()
    assert _scaled_err(got, want, floor) < 5e-11


NELH, NELV, S = 4, 4, 4


@pytest.fixture(scope="module")
def jax_km3():
    """(geom, ops, metric, q, con, hops, ty) of the JAX km3_fused pipeline
    at 4x4x4 (the module shape of tests/test_pallas_euler3d.py)."""
    geom, ops, topo, metric, q = _setup(NELH, NELV, S)
    assert pe3.supported(S, NELH, NELV, 5, jnp.float64)
    con = pe3.build_constants(ops, metric, NELH, NELV, S, dtype=jnp.float64)
    hops = pe3.build_halo_ops(ops, topo, S, dtype=jnp.float64)
    _g, ty, _rp = pe3.grid_plan(S, NELH, NELV)
    return geom, ops, metric, topo, q, con, hops, ty


def _km3(jax_km3, y, **kw):
    geom, ops, metric, topo, q, con, hops, ty = jax_km3
    yp = pe3.pack_state_jnp(jnp.asarray(y), NELH, NELV, S)
    hwe, hs, hn = pe3.edge_halo(yp, topo, hops, NELH, NELV, ty, S)
    for k in ("x",):
        if k in kw:
            kw[k] = pe3.pack_state_jnp(jnp.asarray(kw[k]), NELH, NELV, S)
    out = pe3.km3_fused(yp, hwe, hs, hn, con, NELH, NELV, ty, S, interpret=True, **kw)
    return np.asarray(pe3.unpack_rows_jnp(out, NELH, NELV, S))


@pytest.mark.parametrize("mode", ["rhs", "stage", "stage_x"])
def test_matches_jax_km3_fused(jax_km3, mode):
    geom, ops, metric, topo, q, con, hops, ty = jax_km3
    y = _noisy(q, seed=1)
    x = _noisy(q, seed=2)
    dt = 0.5
    kw = {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=dt), "stage_x": dict(a=0.25, b=0.75, cdt=1.7 * dt)}[mode]
    jkw = {} if mode == "rhs" else dict(cdt=jnp.asarray(kw["cdt"]), stage_a=kw["a"], stage_b=kw["b"])
    if mode == "stage_x":
        jkw["x"] = x
    want = _km3(jax_km3, y, **jkw)
    rhs = interop.euler3d_rhs(geom, ops, metric)
    yt = interop.to_tensor(y)
    if mode == "rhs":
        got = rhs(yt)
    else:
        got, _ = rhs.stage(interop.to_tensor(x), yt, kw["a"], kw["b"], kw["cdt"])
    assert _scaled_err(interop.to_numpy(got), want) < 1e-12


def test_chained_step_and_traces_match_jax_km3_fused(jax_km3):
    """One chained TVD-RK3 step (the kernel emits the next stage's traces)
    against the JAX chained step; the emitted traces against a fresh
    log-space extrapolation of the JAX step's output state. The step starts
    from a noisy state, so rho*w is not zero there."""
    geom, ops, metric, topo, q, con, hops, ty = jax_km3
    q = _noisy(q, seed=3)
    dt = 0.04
    stages = [(0.0, 1.0, 1.0), (0.75, 0.25, 0.25), (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0)]
    qp = pe3.pack_state_jnp(jnp.asarray(q), NELH, NELV, S)
    y, slabs = qp, pe3.edge_halo(qp, topo, hops, NELH, NELV, ty, S)
    for a, b, c in stages:
        y, we = pe3.km3_fused(y, *slabs, con, NELH, NELV, ty, S, x=qp, cdt=jnp.asarray(c * dt), stage_a=a,
                              stage_b=b, emit_slabs=True, interpret=True)
        slabs = pe3.halo_from_slabs(we, y, topo, hops, NELH, NELV, ty, S)
    want = np.asarray(pe3.unpack_rows_jnp(y, NELH, NELV, S))

    rhs = interop.euler3d_rhs(geom, ops, metric)
    q0 = interop.to_tensor(q)
    yt, traces = q0, rhs.traces(q0)
    for a, b, c in stages:
        yt, traces = rhs.stage(q0, yt, a, b, c * dt, traces)
    assert _scaled_err(interop.to_numpy(yt), want) < 1e-12

    ss = S * S
    ext = np.concatenate([ops.extrap_x3, ops.extrap_y3, ops.extrap_z3], axis=1)
    logged = np.concatenate([np.log(want[0:1]), want[1:4], np.log(want[4:5])])
    itf = logged @ ext
    itf = np.concatenate([np.exp(itf[0:1]), itf[1:4], np.exp(itf[4:5])])
    fresh = np.asarray(topo._trace_pool_3d(itf[..., : 2 * ss], itf[..., 2 * ss : 4 * ss]))
    assert _scaled_err(interop.to_numpy(traces), fresh) < 1e-12


def test_float32_balanced_offset_matches_jax():
    nel_h, nel_v, s = 4, 2, 3
    geom, ops, topo, metric, q = _setup(nel_h, nel_v, s)
    truth = np.asarray(j_make_rhs(geom, ops, metric, topo, dtype=jnp.float64, interior="xla")(jnp.asarray(q)))
    scale = np.abs(truth).reshape(5, -1).max(axis=1).reshape(5, 1, 1, 1, 1, 1)
    err = lambda a: float(np.abs((np.asarray(a, np.float64) - truth) / scale).max())

    jax_bal = j_make_rhs(geom, ops, metric, topo, dtype=jnp.float32, interior="pallas", base_state=jnp.asarray(q))
    assert hasattr(jax_bal, "packed")
    want = np.asarray(jax_bal(jnp.asarray(q, jnp.float32)))

    q32 = interop.to_tensor(q, dtype=torch.float32)
    plain = interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32)
    balanced = interop.euler3d_rhs(geom, ops, metric, dtype=torch.float32, base_state=q)
    assert plain.bal is None and balanced.bal.dtype == torch.float32
    got = interop.to_numpy(balanced(q32))
    err_plain, err_bal = err(interop.to_numpy(plain(q32))), err(got)
    assert err_bal < 1e-2 and err_bal < 1e-3 * err_plain, (err_bal, err_plain)
    assert err(want) < 1e-2
    assert float(np.abs((got - want) / scale).max()) < 1e-5


def test_plain_traces_are_face_extrapolations():
    geom, ops, topo, metric, q = _setup(3, 2, 3)
    con = interop.euler3d_constants(ops, metric, 3, 2)
    ss = 9
    ext = np.concatenate([ops.extrap_x3, ops.extrap_y3, ops.extrap_z3], axis=1)
    logged = np.concatenate([np.log(q[0:1]), q[1:4], np.log(q[4:5])])
    itf = logged @ ext
    itf = np.concatenate([np.exp(itf[0:1]), itf[1:4], np.exp(itf[4:5])])
    tr = e3op.edge_traces(interop.to_tensor(q), con).numpy()
    np.testing.assert_allclose(tr[:, 0], itf[:, :, :, 0, :, 2 * ss : 3 * ss], rtol=1e-13, atol=1e-13)  # south
    np.testing.assert_allclose(tr[:, 1], itf[:, :, :, -1, :, 3 * ss : 4 * ss], rtol=1e-13, atol=1e-13)  # north
    np.testing.assert_allclose(tr[:, 2], itf[:, :, :, :, 0, :ss], rtol=1e-13, atol=1e-13)  # west
    np.testing.assert_allclose(tr[:, 3], itf[:, :, :, :, -1, ss : 2 * ss], rtol=1e-13, atol=1e-13)  # east


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    geom, ops, topo, metric, q = _setup(3, 2, 2)
    rhs = interop.euler3d_rhs(geom, ops, metric)
    con = rhs.con
    qt = interop.to_tensor(q)
    halo = rhs.halo(rhs.traces(qt))
    before = e3op.launches
    out = e3op.euler3d_operator(qt, halo, con)
    assert e3op.launches == before  # the CPU runs the plain version: no launch
    torch.testing.assert_close(out, e3op.euler3d_operator_plain(qt, halo, con), rtol=0, atol=0)
    with pytest.raises(ValueError):
        e3op.euler3d_operator(qt.float(), halo.float(), con)  # dtype differs from the constants
    with pytest.raises(ValueError):
        e3op.euler3d_operator(qt[:, :, :1].contiguous(), halo, con)  # wrong shape
    with pytest.raises(ValueError):
        e3op.euler3d_operator(qt, halo, con, a=0.5, b=0.5, cdt=1.0)  # a != 0 needs x
    with pytest.raises(ValueError):
        e3op.euler3d_operator(qt, halo, con, bal=qt[:, :, :1])  # bal of the wrong shape
    with pytest.raises(ValueError):
        e3op.euler3d_operator(qt.transpose(3, 4), halo, con)  # right shape, not contiguous
