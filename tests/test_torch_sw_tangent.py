"""The shallow-water Jacobian action of the port (``ops/sw_operator.py``:
``sw_tangent_plain``, ``torch.func.jvp`` of the plain operator with its halo
taken from the state; ``ShallowWaterRHS.jtv``) against the JAX package's
``jax.jvp`` of its XLA RHS, on the CPU, from the same seeded numpy inputs
(``kernels/check.py::sw_tangent_inputs``: case 6 plus 1e-3 of each
variable's max of noise, a direction of 1e-3 of each variable's max).

* float64 at nel = 3-4, s = 2..5, Williamson cases 2 and 6: within 1e-12 of
  each variable's max of the JAX J.v.
* The state at rest (case 6's h, no momentum): every interface's split Mach
  number is exactly 0. ``jax.jvp`` of ``jnp.maximum(0, M)`` and
  ``jnp.minimum(0, M)`` gives half of dM there, ``torch.clamp`` all of it;
  the port writes the split as 0.5 (M +- |M|), so it equals JAX at the tie
  (1e-12), and the AUSM flux's tangent at the tie is half of what a full
  share would give.
* The operator's forward values are unchanged by that rewrite: the plain
  RHS equals its own torch.clamp form bit for bit.
* The float32 perturbation-form companion's ``jtv`` is the absolute
  float32 operator's J.v (the JAX rule: ``jax.jvp(rhs32.xla, ...)``), bit
  for bit the plain float32 tangent at the absolute state, within 1e-4 of
  the JAX float32 J.v's max per variable, both within 1e-4 of the float64
  J.v.
* The wrapper on the CPU runs the plain tangent (counted), and the
  tangent's linearity, mass and agreement with a centred difference to
  second order hold (``compare_sw_tangent``, the card's check run on the
  CPU, where the prep and apply wrappers run their plain versions).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.testcases import williamson_case2, williamson_case6
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.common.constants import GRAVITY
from wxfactory_tpu_torch.kernels import check
from wxfactory_tpu_torch.ops import sw_operator as swop

torch.set_num_threads(1)


def _setup(nel, s, case=6):
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    q0 = np.asarray(williamson_case6(geom) if case == 6 else williamson_case2(geom))
    return geom, ops, metric, q0


def _scale(a):
    return np.abs(a).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)


def _err(got, want):
    return float(np.abs((got - want) / _scale(want)).max())


def _inputs(q0, seed=7, rest=False):
    rng = np.random.default_rng(seed)
    scale = 1e-3 * _scale(q0)
    q = q0 + scale * rng.standard_normal(q0.shape)
    if rest:
        q = np.concatenate([q0[:1], np.zeros_like(q0[1:])])
    return q, scale * rng.standard_normal(q0.shape)


def _jax_jvp(rhs, q, v):
    return np.asarray(jax.jvp(rhs, (jnp.asarray(q),), (jnp.asarray(v),))[1])


@pytest.mark.parametrize("nel,s,case", [(3, 2, 6), (4, 3, 6), (3, 4, 2), (3, 5, 6), (4, 3, 2)],
                         ids=["3x2-case6", "4x3-case6", "3x4-case2", "3x5-case6", "4x3-case2"])
def test_plain_tangent_matches_jax_jvp(nel, s, case):
    geom, ops, metric, q0 = _setup(nel, s, case)
    q, v = _inputs(q0)
    want = _jax_jvp(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla"), q, v)
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    got = swop.sw_tangent_plain(interop.to_tensor(q), interop.to_tensor(v), rhs.con, rhs.topology)
    assert _err(got.numpy(), want) < 1e-12
    # The model's Jacobian action is the same function.
    assert torch.equal(rhs.jtv(interop.to_tensor(q), interop.to_tensor(v)), got)


@pytest.mark.parametrize("nel,s", [(3, 3), (4, 2)], ids=["3x3", "4x2"])
def test_plain_tangent_at_rest_matches_jax_at_the_tie(nel, s):
    geom, ops, metric, q0 = _setup(nel, s)
    q, v = _inputs(q0, rest=True)
    want = _jax_jvp(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla"), q, v)
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    got = swop.sw_tangent_plain(interop.to_tensor(q), interop.to_tensor(v), rhs.con, rhs.topology).numpy()
    assert _err(got, want) < 1e-12


def test_ausm_tangent_takes_half_of_dm_at_the_tie():
    # A state at rest on both sides: M = 0 exactly. d max(0, M) = d min(0, M)
    # = dM / 2 (jax.jvp's rule), so the mass flux's tangent is
    # msg * dM / 2 * (aL hL + aR hR); torch.clamp's rule would double it.
    t = lambda *a: torch.tensor(a, dtype=torch.float64)
    qL, qR = t(9000.0, 0.0, 0.0), t(9500.0, 0.0, 0.0)
    dL, dR = t(3.0, 2.0e2, -1.0e2), t(-1.0, 5.0e2, 4.0e2)
    msg, mhd, mho = t(1.3), t(0.8), t(0.1)
    flux = lambda a, b: swop._ausm(a, b, msg, mhd, mho, is_x=True)
    _, dF = torch.func.jvp(flux, (qL, qR), (dL, dR))
    aL, aR = torch.sqrt(GRAVITY * qL[0] * mhd), torch.sqrt(GRAVITY * qR[0] * mhd)
    dmL, dmR = dL[1] / (qL[0] * aL), dR[1] / (qR[0] * aR)  # m = 0 on both sides
    dM = 0.5 * (dmL + dmR)
    want = msg * 0.5 * dM * (aL * qL[0] + aR * qR[0])
    torch.testing.assert_close(dF[0], want, rtol=1e-14, atol=0.0)
    assert abs(float(dF[0]) - float(2 * want)) > 0.4 * abs(float(want))


def test_forward_operator_values_are_unchanged_by_the_split_rewrite():
    geom, ops, metric, q0 = _setup(4, 3)
    rng = np.random.default_rng(3)
    # Mach numbers of both signs, exact zeros at rest.
    for q in (q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape)), np.concatenate([q0[:1], 0 * q0[1:]])):
        rhs = interop.shallow_water_rhs(geom, ops, metric)
        qt = interop.to_tensor(q)
        halo = swop.halo_from_traces(swop.edge_traces(qt, rhs.con), rhs.topology)
        qL_x, qR_x, _, _ = swop._interface_states(qt @ rhs.con.ee, halo, rhs.con.s)
        msg, mhd, mho = rhs.con.itf_x
        got = swop._ausm(qL_x, qR_x, msg, mhd, mho, is_x=True)
        # The clamp form of the split, written out.
        hL, hR = qL_x[0], qR_x[0]
        aL, aR = torch.sqrt(GRAVITY * hL * mhd), torch.sqrt(GRAVITY * hR * mhd)
        mL = torch.where(hL * aL != 0.0, qL_x[1] / (hL * aL), 0.0)
        mR = torch.where(hR * aR != 0.0, qR_x[1] / (hR * aR), 0.0)
        big_m = 0.25 * ((mL + 1.0) ** 2 - (mR - 1.0) ** 2)
        adv = torch.clamp(big_m, min=0.0) * aL, torch.clamp(big_m, max=0.0) * aR
        want0 = msg * (adv[0] * qL_x[0] + adv[1] * qR_x[0])
        assert torch.equal(got[0], want0)


def test_f32_companion_jtv_is_the_absolute_operators_jvp():
    nel, s = 4, 3
    geom, ops, metric, q0 = _setup(nel, s)
    q, v = _inputs(q0)
    q32, v32 = q.astype(np.float32), v.astype(np.float32)
    jrhs32 = j_make_rhs(geom, ops, metric, dtype=jnp.float32, interior="xla", perturbation_base=jnp.asarray(q0))
    want = _jax_jvp(jrhs32.xla, q32, v32).astype(np.float64)
    truth = _jax_jvp(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla"), q32.astype(np.float64),
                     v32.astype(np.float64))
    sw32 = interop.shallow_water_rhs(geom, ops, metric, dtype=torch.float32, perturbation_base=q0)
    qt, vt = torch.as_tensor(q32), torch.as_tensor(v32)
    got = sw32.jtv(qt, vt)
    assert got.dtype == torch.float32
    # The absolute float32 operator's J.v, bit for bit, at the absolute state.
    assert torch.equal(got, swop.sw_tangent_plain(qt, vt, sw32.con, sw32.topology))
    got = got.double().numpy()
    assert _err(got, want) < 1e-4
    assert _err(got, truth) < 1e-4 and _err(want, truth) < 1e-4


def test_wrapper_on_cpu_runs_the_counted_plain_tangent():
    con, topology, states, v, _ = check.sw_tangent_inputs(3, 3, torch.float64, "cpu")
    counts = lambda: (swop.plain_tangent_calls, swop.tangent_prep_launches, swop.tangent_apply_launches)
    before = counts()
    swop.sw_tangent(states["case6"], v, con, topology)
    assert counts() == (before[0] + 1, before[1], before[2])
    with pytest.raises(ValueError, match="topology"):
        swop.sw_tangent(states["case6"], v, con, None)


@pytest.mark.parametrize("nel,s", [(3, 3), (2, 5)], ids=["3x3", "2x5"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_tangent_check_holds_on_the_cpu(nel, s, dtype):
    # chip_smoke phase 29's comparison with both sides the plain tangent:
    # linearity, mass and (f64) the centred difference's second order.
    rows = check.compare_sw_tangent(nel, s, dtype, device="cpu")
    assert all(r["ok"] for r in rows), rows
    if dtype == torch.float64:
        fd = next(r for r in rows if r["mode"] == "tangent_case6")
        assert 1.8 < fd["fd_order"] < 2.2, fd
