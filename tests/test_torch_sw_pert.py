"""The port's shallow-water perturbation (base-state-split) form against the
JAX package, on the CPU, where the wrappers run the plain torch versions.

* The operator, float64, at (nel, s) = (10, 3), (4, 6), (8, 4): the port's
  ``delta(dq)`` against the JAX ``rhs_pert.delta`` (``interior="xla"``) and
  against the JAX Pallas kernels with base planes in interpret mode
  (``km_gen`` at s=3 and 6, ``km_fused`` at s=4), within 1e-12 of each
  variable's max, the JAX kernel test's bound (tests/test_pallas_gen.py:
  104-122). dq = 1e-3 q0 sin(0.37 k) moves face Mach numbers across zero,
  where a split-Mach branch that differs would show.
* Stages of deltas reproduce the absolute Euler step (rtol 1e-10, atol
  1e-7, tests/test_pallas_gen.py:125-153); chained stages equal unchained
  ones; the delta RHS conserves mass to round-off.
* TVD-RK3 in perturbation form, f64, nel=10, s=3, 10 steps: the port's
  ``Tvdrk3`` against the JAX ``Tvdrk3`` on its Pallas perturbation RHS
  (``_PackedChain`` over ``km_gen`` with base planes), within 1e-11 of scale;
  the stage chain packs once and keeps the packed twin.
* float32 at the bench's 4-step drift state (bench.py:425-446): the port's
  f32 perturbation RHS against the f64 truth, below twice the JAX f32
  perturbation form's own error and below the bench's gate 5e-3 of the
  tendency scale; the f32 absolute form's error, printed beside it, is
  larger.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.integrators import Tvdrk3 as JTvdrk3
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.testcases import williamson_case6
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.integrators import Tvdrk3
from wxfactory_tpu_torch.kernels.check import sw_delta
from wxfactory_tpu_torch.output.diagnostics import global_integral_2d

torch.set_num_threads(1)

GATE_REL = 5e-3  # bench.py:309


def _setup(nel, s):
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    return geom, ops, metric, williamson_case6(geom)


def _scale(a):
    return np.abs(a).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)


def _err(got, want, scale=None):
    return float(np.abs((got - want) / (_scale(want) if scale is None else scale)).max())


SHAPES = [(10, 3), (4, 6), (8, 4)]
IDS = ["10x3", "4x6", "8x4"]


@pytest.mark.parametrize("nel,s", SHAPES, ids=IDS)
def test_pert_delta_matches_jax_xla(nel, s):
    geom, ops, metric, q0 = _setup(nel, s)
    dq = sw_delta(q0)
    jr = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla", perturbation_base=jnp.asarray(q0))
    want = np.asarray(jr.delta(jnp.asarray(dq)))
    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=q0)
    got = interop.to_numpy(rhs.delta(interop.to_tensor(dq)))
    assert _err(got, want) < 1e-12
    # The absolute state goes in through __call__, as into the JAX rhs_pert.
    got_abs = interop.to_numpy(rhs(interop.to_tensor(q0 + dq)))
    assert _err(got_abs, np.asarray(jr(jnp.asarray(q0 + dq)))) < 1e-12
    np.testing.assert_array_equal(interop.to_numpy(rhs.base_state), q0)


@pytest.mark.parametrize("nel,s", SHAPES, ids=["10x3-km_gen", "4x6-km_gen", "8x4-km_fused"])
def test_pert_delta_matches_jax_pallas_kernel(nel, s):
    geom, ops, metric, q0 = _setup(nel, s)
    dq = sw_delta(q0)
    jr = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="pallas", perturbation_base=jnp.asarray(q0))
    assert hasattr(jr, "packed_stage_chained"), "the JAX Pallas perturbation pipeline should be active"
    want = np.asarray(jr.delta(jnp.asarray(dq)))
    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=q0)
    got = interop.to_numpy(rhs.delta(interop.to_tensor(dq)))
    assert _err(got, want) < 1e-12


@pytest.mark.parametrize("nel,s", [(10, 3), (8, 4)], ids=["10x3", "8x4"])
def test_pert_stages_reproduce_absolute_euler_step(nel, s):
    geom, ops, metric, q0 = _setup(nel, s)
    dq = sw_delta(q0)
    dt = 30.0
    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=q0)
    qp = rhs.pack(interop.to_tensor(q0 + dq))
    y1, tr1 = rhs.stage(qp, qp, 0.0, 1.0, dt)
    want = q0 + dq + dt * np.asarray(j_make_rhs(geom, ops, metric, dtype=jnp.float64,
                                                interior="xla")(jnp.asarray(q0 + dq)))
    np.testing.assert_allclose(interop.to_numpy(rhs.unpack(y1)), want, rtol=1e-10, atol=1e-7)
    # chained (traces from the previous stage) equals unchained, and the
    # emitted traces equal a fresh bootstrap of the output
    y1c, _ = rhs.stage(qp, qp, 0.0, 1.0, dt, rhs.traces(qp))
    torch.testing.assert_close(y1c, y1, rtol=0, atol=0)
    torch.testing.assert_close(tr1, rhs.traces(y1), rtol=1e-13, atol=1e-9)
    coeffs = [(0.0, 1.0, 1.0), (0.75, 0.25, 0.25), (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0)]
    y, tr = qp, rhs.traces(qp)
    yu = qp
    for a, b, c in coeffs:
        y, tr = rhs.stage(qp, y, a, b, c * dt, tr)
        yu, _ = rhs.stage(qp, yu, a, b, c * dt)
    torch.testing.assert_close(y, yu, rtol=1e-13, atol=1e-10)


@pytest.mark.parametrize("nel,s", [(10, 3), (4, 6), (8, 4)], ids=IDS)
def test_pert_delta_conserves_mass(nel, s):
    """Both sides of an interior interface get the same delta flux (base
    traces from the owner's itf0, delta traces re-extrapolated in the same
    order), so the h row of the delta RHS integrates to round-off."""
    geom, ops, metric, q0 = _setup(nel, s)
    dq = sw_delta(q0)
    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=q0)
    delta = interop.to_numpy(rhs.delta(interop.to_tensor(dq)) - rhs.base.rhs0)
    total = global_integral_2d(np.abs(delta[0]), ops, metric)
    assert abs(global_integral_2d(delta[0], ops, metric)) < 1e-12 * total


def test_tvdrk3_pert_matches_jax_packed_chain():
    nel, s, dt, nsteps = 10, 3, 30.0, 10
    geom, ops, metric, q0 = _setup(nel, s)
    jr = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="pallas", perturbation_base=jnp.asarray(q0))
    jint = JTvdrk3(jr)
    assert jint._packed is not None  # the chained km_gen path with base planes
    qj = jnp.asarray(q0)
    for _ in range(nsteps):
        qj = jint.step(qj, dt)
    want = np.asarray(qj)

    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=q0)
    packs = []
    pack = rhs.pack
    rhs.pack = lambda q: packs.append(1) or pack(q)
    integ = Tvdrk3(rhs)
    q = interop.to_tensor(q0)
    for _ in range(nsteps):
        q = integ.step(q, dt)
    assert len(packs) == 1  # packed once; the packed twin rides in the cache
    got = interop.to_numpy(q)
    assert _err(got, want) < 1e-11
    mass = lambda a: global_integral_2d(a[0], ops, metric)
    assert abs(mass(got) - mass(q0)) < 1e-12 * abs(mass(q0))


def _rk3_steps(rhs64, q, dt, nsteps):
    for _ in range(nsteps):
        k1 = q + dt * rhs64(q)
        k2 = 0.75 * q + 0.25 * (k1 + dt * rhs64(k1))
        q = q / 3.0 + (2.0 / 3.0) * (k2 + dt * rhs64(k2))
    return q


@pytest.mark.parametrize("nel,s", [(10, 3), (8, 4)], ids=["10x3", "8x4"])
def test_f32_pert_accuracy_at_drift_state(nel, s):
    """bench.py:425-446: the f32 perturbation RHS at the IC advanced four
    f64 TVD-RK3 steps (dt = 150 (10/nel)(3/s)), base = the IC."""
    geom, ops, metric, q0 = _setup(nel, s)
    rhs64 = jax.jit(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla"))
    qt = _rk3_steps(rhs64, jnp.asarray(q0), 150.0 * (10.0 / nel) * (3.0 / s), 4)
    truth = np.asarray(rhs64(qt))
    scale = _scale(truth)
    j32 = j_make_rhs(geom, ops, metric, dtype=jnp.float32, interior="xla", perturbation_base=jnp.asarray(q0))
    err_jax = _err(np.asarray(j32.delta((qt - j32.base_state).astype(jnp.float32)), np.float64), truth, scale)

    r32 = interop.shallow_water_rhs(geom, ops, metric, dtype=torch.float32, perturbation_base=q0)
    qt_t = interop.to_tensor(np.asarray(qt))
    got = r32.delta((qt_t - r32.base_state.double()).float())
    err = _err(interop.to_numpy(got).astype(np.float64), truth, scale)
    a32 = interop.shallow_water_rhs(geom, ops, metric, dtype=torch.float32)
    err_abs = _err(interop.to_numpy(a32(qt_t.float())).astype(np.float64), truth, scale)
    print(f"f32 perturbation {err:.3e} (JAX {err_jax:.3e}), f32 absolute {err_abs:.3e} of tendency scale")
    assert err < 2.0 * err_jax and err < GATE_REL
    assert err < err_abs


def test_pack_unpack_and_absolute_operator():
    nel, s = 4, 3
    geom, ops, metric, q0 = _setup(nel, s)
    dq = sw_delta(q0)
    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=q0)
    q = interop.to_tensor(q0 + dq)
    torch.testing.assert_close(rhs.unpack(rhs.pack(q)), q, rtol=1e-15, atol=0)
    absolute = interop.shallow_water_rhs(geom, ops, metric)
    torch.testing.assert_close(rhs.xla(q), absolute(q), rtol=0, atol=0)
    assert absolute.pack(q) is q and absolute.unpack(q) is q
    with pytest.raises(ValueError, match="perturbation_base"):
        absolute.delta(q)
