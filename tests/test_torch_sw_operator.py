"""The port's shallow-water operator (wxfactory_tpu_torch.ops.sw_operator)
against the JAX package, float64 on the CPU, where the wrapper runs the
plain torch version.

* RHS mode against ``make_rhs_shallow_water(interior="xla")``: 5e-12 of
  scale, the JAX kernel test's bound (tests/test_pallas_gen.py) — the
  operator factors the time Christoffels as 2*gridrot*coriolis_factor where
  the XLA form uses 2*christoffel, and sums in another order. For case 6 the
  scale is each variable's max |RHS|, as there. Case 2 is a steady state:
  its RHS is the truncation-error residual of terms 1e3-1e8 times larger,
  so max-scaling it measures round-off of those terms (the JAX package's own
  km_gen differs from its XLA RHS by 1.4e-11 to 2.6e-8 of that residual at
  these shapes); there the scale is each variable's max flux-divergence
  term, the size of what cancels.
* Stage mode and emitted traces against the JAX ``km_gen`` kernel run in
  Pallas interpret mode (``packed_stage`` / ``packed_stage_chained``),
  unpacked through the JAX pipeline: rtol 1e-12, as there, with an atol of
  1e-12 of each variable's max for entries that cross zero (the momenta),
  where two implementations have no relative digits in common.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.common.constants import GRAVITY
from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops import pallas_sw_gen
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.parallel.topology import CubedSphereTopology as JTopology
from wxfactory_tpu.testcases import williamson_case2, williamson_case6
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.ops import sw_operator as swop

torch.set_num_threads(1)

CASES = {2: williamson_case2, 6: williamson_case6}


def _setup(nel, s, case=6, rotation=(0.0, 0.0, 0.0)):
    geom = make_cubed_sphere_2d(nel, s, *rotation)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    q = CASES[case](geom)
    return geom, ops, metric, q


def _scaled_err(got, want, scale=None):
    if scale is None:
        scale = np.abs(want).reshape(3, -1).max(axis=1)
    scale = np.asarray(scale).reshape((3,) + (1,) * (want.ndim - 1))
    return float(np.abs((got - want) / scale).max())


def _assert_close(got, want, rtol=1e-12):
    for v in range(3):
        np.testing.assert_allclose(got[v], want[v], rtol=rtol, atol=rtol * np.abs(want[v]).max())


def _flux_divergence_scale(q, ops, metric):
    """Per-variable max of |inv_sqrtG * div(F)|, the pointwise-flux term of
    the RHS (models/shallow_water.py:195-210 of the JAX package)."""
    h, hu1, hu2 = q
    u1, u2 = hu1 / h, hu2 / h
    sg, half_g, hsq = metric.sqrtG, 0.5 * GRAVITY, h * h
    fx = [sg * hu1, sg * (hu1 * u1 + half_g * metric.H_contra_11 * hsq),
          sg * (hu2 * u1 + half_g * metric.H_contra_21 * hsq)]
    fy = [sg * hu2, sg * (hu1 * u2 + half_g * metric.H_contra_12 * hsq),
          sg * (hu2 * u2 + half_g * metric.H_contra_22 * hsq)]
    dd = np.concatenate([ops.derivative_x, ops.derivative_z], axis=0)
    div = np.stack([np.concatenate([a, b], axis=-1) @ dd for a, b in zip(fx, fy)])
    return np.abs(metric.inv_sqrtG * div).reshape(3, -1).max(axis=1)


@pytest.mark.parametrize(
    "nel,s,case,rotation",
    [
        (10, 3, 6, (0.0, 0.0, 0.0)),
        (4, 6, 6, (0.0, 0.0, 0.0)),
        (3, 8, 6, (0.0, 0.0, 0.0)),
        (10, 3, 2, (0.0, 0.0, 0.0)),
        (4, 6, 2, (0.0, 0.0, 0.0)),
        (3, 8, 2, (0.0, 0.0, 0.0)),
        (5, 3, 6, (0.3, 0.7853981633974483, 0.2)),
        (5, 3, 2, (0.3, 0.7853981633974483, 0.2)),
    ],
    ids=["c6-10x3", "c6-4x6", "c6-3x8", "c2-10x3", "c2-4x6", "c2-3x8", "c6-rot", "c2-rot"],
)
def test_plain_rhs_matches_jax_xla(nel, s, case, rotation):
    geom, ops, metric, q = _setup(nel, s, case, rotation)
    want = np.asarray(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla")(jnp.asarray(q)))
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    got = interop.to_numpy(rhs(interop.to_tensor(q)))
    assert got.shape == want.shape
    scale = None if case == 6 else _flux_divergence_scale(q, ops, metric)
    assert _scaled_err(got, want, scale) < 5e-12


@pytest.fixture(scope="module")
def jax_pipeline():
    nel, s = 10, 3
    geom, ops, metric, q = _setup(nel, s)
    rhs = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="pallas")
    assert hasattr(rhs, "packed_stage_chained"), "JAX generic Pallas pipeline should be active"
    return geom, ops, metric, q, rhs


@pytest.mark.parametrize("a,b,c", [(0.0, 1.0, 1.0), (0.75, 0.25, 0.25)], ids=["no-x", "with-x"])
def test_stage_matches_jax_km_gen(jax_pipeline, a, b, c):
    geom, ops, metric, q, jrhs = jax_pipeline
    dt = 30.0
    rng = np.random.default_rng(7)
    y = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
    qp, yp = jrhs.pack(jnp.asarray(q)), jrhs.pack(jnp.asarray(y))
    want = np.asarray(jrhs.unpack(jrhs.packed_stage(qp, yp, a, b, jnp.asarray(c * dt)))).reshape(q.shape)

    rhs = interop.shallow_water_rhs(geom, ops, metric)
    got, _ = rhs.stage(interop.to_tensor(q), interop.to_tensor(y), a, b, c * dt)
    _assert_close(interop.to_numpy(got), want)


def test_chained_stages_and_traces_match_jax_km_gen(jax_pipeline):
    geom, ops, metric, q, jrhs = jax_pipeline
    nel, s = geom.num_elements, geom.num_solpts
    dt = 30.0
    coeffs = [(0.0, 1.0, 1.0), (0.75, 0.25, 0.25), (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0)]
    qp = jrhs.pack(jnp.asarray(q))
    y, slabs = qp, jrhs.packed_slabs(qp)
    for a, b, c in coeffs:
        y, slabs = jrhs.packed_stage_chained(qp, y, slabs, a, b, jnp.asarray(c * dt))
    want = np.asarray(jrhs.unpack(y)).reshape(q.shape)

    rhs = interop.shallow_water_rhs(geom, ops, metric)
    q0 = interop.to_tensor(q)
    yt, traces = q0, rhs.traces(q0)
    for a, b, c in coeffs:
        yt, traces = rhs.stage(q0, yt, a, b, c * dt, traces)
    _assert_close(interop.to_numpy(yt), want)

    # The emitted traces feed the next halo: compare the halos both packages
    # build from their emitted edge data (JAX: (6, 3, npl) per side).
    conv = jnp.asarray(JTopology(geom)._conv_contra_all)
    jhalo = pallas_sw_gen.halo_from_slabs(*slabs, JTopology(geom), conv, nel, s)
    halo = interop.to_numpy(rhs.halo(traces))  # (3, 4, 6, nel, s), sides S, N, W, E
    for side, jh in zip((2, 3, 0, 1), jhalo):  # JAX order: W, E, S, N
        jh = np.swapaxes(np.asarray(jh)[:, :, : nel * s], 0, 1).reshape(3, 6, nel, s)
        _assert_close(halo[:, side], jh)


def test_plain_traces_are_edge_extrapolations():
    geom, ops, metric, q = _setup(4, 3)
    con = interop.sw_constants(ops, metric, 4)
    qt = interop.to_tensor(q)
    itf = q @ np.concatenate([ops.extrap_x, ops.extrap_z], axis=1)  # (3, 6, nel, nel, 4s)
    tr = swop.edge_traces(qt, con).numpy()
    s = 3
    np.testing.assert_allclose(tr[:, 0], itf[:, :, 0, :, 2 * s : 3 * s], rtol=1e-14)  # south
    np.testing.assert_allclose(tr[:, 1], itf[:, :, -1, :, 3 * s :], rtol=1e-14)  # north
    np.testing.assert_allclose(tr[:, 2], itf[:, :, :, 0, :s], rtol=1e-14)  # west
    np.testing.assert_allclose(tr[:, 3], itf[:, :, :, -1, s : 2 * s], rtol=1e-14)  # east


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    geom, ops, metric, q = _setup(3, 2)
    con = interop.sw_constants(ops, metric, 3)
    qt = interop.to_tensor(q)
    halo = swop.halo_from_traces(swop.edge_traces(qt, con), interop.shallow_water_rhs(geom, ops, metric).topology)
    before = swop.launches
    out = swop.sw_operator(qt, halo, con)
    assert swop.launches == before  # the CPU runs the plain version: no launch
    torch.testing.assert_close(out, swop.sw_operator_plain(qt, halo, con), rtol=0, atol=0)
    with pytest.raises(ValueError):
        swop.sw_operator(qt.float(), halo.float(), con)  # dtype differs from the constants
    with pytest.raises(ValueError):
        swop.sw_operator(qt[:, :, :2], halo, con)  # wrong shape
    with pytest.raises(ValueError):
        swop.sw_operator(qt, halo, con, a=0.5, b=0.5, cdt=1.0)  # a != 0 needs x
    with pytest.raises(ValueError):
        swop.sw_operator(qt.transpose(2, 3), halo, con)  # right shape, not contiguous
