"""The shallow-water operator's state mode (``halo=None``: each panel-edge
face takes its neighbour's values from the neighbour panel's state, one
launch on the card where the edge-trace, halo and operator kernels took
three), on the CPU.

* ``ops/sw_operator.py::panel_edge_plan``, the numpy mirror of the kernel's
  panel-edge indexing (csrc/sw_element.cuh: ``halo_source``,
  ``edge_trace``, ``rotate_halo``), applied to a seeded state with the 1D
  face extrapolation of ``element_plan`` and the halo tables' rotation,
  matches ``halo_from_traces(edge_traces(q))`` within 1e-15 of each
  variable's max at s = 2..8, nel = 2..5; the JAX package's
  ``pallas_sw_gen.halo_from_slabs`` of its own ``packed_slabs`` at s = 2..8
  within 1e-14 (its slabs come from dense products); and the JAX
  ``kh_exchange`` (interpret mode, nel = 32, s = 4) of the port's traces
  within 1e-14.
* The plain operator with ``halo=None`` equals (``torch.equal``) the plain
  operator fed the explicit halo of its input's traces: absolute and
  perturbation form, RHS and stages with a = 0 and a != 0.
* Three TVD-RK3 steps of ``ShallowWaterRHS`` (one state-mode operator call
  a stage, no traces carried) against the JAX ``Tvdrk3`` on the XLA RHS
  (absolute) and on the perturbation RHS, within 1e-11 of each variable's
  max (the SW chain tolerance of tests/test_torch_explicit.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry import make_cubed_sphere_2d as j_make_cubed_sphere_2d
from wxfactory_tpu.geometry import make_metric_2d as j_make_metric_2d
from wxfactory_tpu.integrators import Tvdrk3 as JTvdrk3
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops import pallas_sw, pallas_sw_gen
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_make_dfr_operators
from wxfactory_tpu.parallel.topology import CubedSphereTopology as JTopology
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.integrators import Tvdrk3
from wxfactory_tpu_torch.kernels.check import case6_inputs, sw_delta, sw_pert_inputs
from wxfactory_tpu_torch.ops import sw_operator as swop

torch.set_num_threads(1)

SOLPTS = list(range(2, 9))


def _scaled(got, want):
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1)
    return float((np.abs(got - want).reshape(want.shape[0], -1).max(axis=1) / scale).max())


def _plan_halo(q: np.ndarray, con, topology) -> np.ndarray:
    """The halo (3, 4, 6, nel, s) the state mode's panel-edge faces compute,
    from the plan: each point's neighbour face trace summed over its s
    nodes in the kernel's order, then the 2x2 rotation of the momenta."""
    nel, s = con.nel, con.s
    plan = swop.panel_edge_plan(nel, s, topology)
    ep = swop.element_plan(s)
    factors = con.ops.numpy()[ep["factors"]]
    fi = plan["face"] * s + plan["k"]
    nodes, weights = ep["face_nodes"][fi], factors[ep["face_factor"][fi]]
    flat = q.reshape(3, 6 * nel * nel, s * s)
    t = np.zeros((3,) + plan["elem"].shape)
    for m in range(s):
        t = t + flat[:, plan["elem"], nodes[..., m]] * weights[..., m]
    conv = swop.halo_tables(topology, "cpu", torch.float64).conv.numpy().reshape(4, -1)[:, plan["conv"]]
    return np.stack([t[0], conv[0] * t[1] + conv[1] * t[2], conv[2] * t[1] + conv[3] * t[2]])


@pytest.mark.parametrize("nel", [2, 3, 4, 5])
@pytest.mark.parametrize("s", SOLPTS)
def test_panel_edge_plan_matches_halo_of_edge_traces(s, nel):
    con, topology, _, y = case6_inputs(nel, s, torch.float64, "cpu", seed=nel + 10 * s)
    want = swop.halo_from_traces(swop.edge_traces(y, con), topology).numpy()
    got = _plan_halo(y.numpy(), con, topology)
    assert got.shape == want.shape == (3, 4, 6, nel, s)
    assert _scaled(got, want) < 1e-15


def test_panel_edge_plan_reads_only_facing_edge_elements():
    # Every neighbour point lies on the element row or column at the panel
    # edge that faces the receiving edge, and each (panel, edge element,
    # face, k) is read exactly once over the 24 rows.
    nel, s = 4, 3
    topology = case6_inputs(nel, s, torch.float64, "cpu")[1]
    plan = swop.panel_edge_plan(nel, s, topology)
    elem, face, k = plan["elem"], plan["face"], plan["k"]
    ey, ex = (elem % (nel * nel)) // nel, elem % nel
    on_edge = np.choose(face, [ex == 0, ex == nel - 1, ey == 0, ey == nel - 1])
    assert on_edge.all()
    keys = (elem * 4 + face) * s + k
    assert np.unique(keys).size == keys.size


@pytest.mark.parametrize("s", SOLPTS)
def test_panel_edge_plan_matches_jax_halo_from_slabs(s):
    nel = 2 + s % 4
    geom = j_make_cubed_sphere_2d(nel, s)
    ops, metric = j_make_dfr_operators(s), j_make_metric_2d(geom)
    con, topology, _, y = case6_inputs(nel, s, torch.float64, "cpu", seed=s)
    jr = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="pallas")
    slabs = jr.packed_slabs(jr.pack(jnp.asarray(y.numpy())))
    conv = jnp.asarray(JTopology(geom)._conv_contra_all)
    jhalo = pallas_sw_gen.halo_from_slabs(*slabs, JTopology(geom), conv, nel, s)  # sides W, E, S, N
    want = np.empty((3, 4, 6, nel, s))
    for side, jh in zip((2, 3, 0, 1), jhalo):
        want[:, side] = np.swapaxes(np.asarray(jh)[:, :, : nel * s], 0, 1).reshape(3, 6, nel, s)
    assert _scaled(_plan_halo(y.numpy(), con, topology), want) < 1e-14


def test_panel_edge_plan_matches_jax_kh_exchange():
    nel, s = 32, 4
    con, topology, _, y = case6_inputs(nel, s, torch.float64, "cpu", seed=3)
    npts = nel * s
    pool = swop.edge_traces(y, con).numpy().reshape(3, 4, 6, npts)
    hc = pallas_sw.build_halo_constants(JTopology(j_make_cubed_sphere_2d(nel, s)), dtype=jnp.float64)
    hwe, hs, hn = (np.asarray(a) for a in pallas_sw.kh_exchange(jnp.asarray(pool), hc, interpret=True))
    want = np.stack([hs[:, :, 0, :npts], hn[:, :, 0, :npts],
                     np.moveaxis(hwe[:, :, 0], 0, 1), np.moveaxis(hwe[:, :, 1], 0, 1)], axis=1)
    got = _plan_halo(y.numpy(), con, topology).reshape(3, 4, 6, npts)
    assert _scaled(got, want) < 1e-14


MODES = {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=30.0), "stage_x": dict(a=0.75, b=0.25, cdt=7.5)}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", ["absolute", "perturbation"])
def test_plain_operator_without_halo_equals_explicit_halo(form, mode, dtype):
    nel, s = 4, 3
    if form == "absolute":
        con, topology, x, q = case6_inputs(nel, s, dtype, "cpu")
        base = None
    else:
        con, topology, base, q, x = sw_pert_inputs(nel, s, dtype, "cpu")
    kw = dict(MODES[mode], base=base)
    if kw.get("a"):
        kw["x"] = x
    halo = swop.halo_from_traces(swop.edge_traces(q, con), topology)
    want = swop.sw_operator(q, halo, con, **kw)
    got = swop.sw_operator(q, None, con, topology=topology, **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="topology"):
        swop.sw_operator(q, None, con, **kw)


@pytest.mark.parametrize("other", [(5, 3), (3, 4), (4, 2)], ids=["nel", "same_points", "s"])
@pytest.mark.parametrize("entry", ["operator", "plain", "run"])
def test_state_mode_refuses_a_topology_of_another_grid(entry, other):
    """The kernels index the halo tables from the constants' nel and s, so
    the wrappers refuse another grid's topology before any launch."""
    nel, s = 4, 3 if entry != "run" else 4
    if entry == "run" and other == (3, 4):
        other = (4, 3)
    con, _, base, dq, _ = sw_pert_inputs(nel, s, torch.float64, "cpu")
    topology = case6_inputs(*other, torch.float64, "cpu")[1]
    assert (topology.nel_h, topology.geom.num_solpts) != (nel, s)
    call = {
        "operator": lambda: swop.sw_operator(dq, None, con, base=base, topology=topology),
        "plain": lambda: swop.sw_operator_pert_plain(dq, None, con, base, topology=topology),
        "run": lambda: swop.sw_run(dq, 1, swop.tvdrk3_abc(30.0), con, topology, base=base),
    }[entry]
    with pytest.raises(ValueError, match="topology has nel"):
        call()


def test_chain_is_one_operator_call_a_stage():
    nel, s = 4, 4
    con, topology, base, dq, _ = sw_pert_inputs(nel, s, torch.float64, "cpu")
    calls = swop.plain_calls
    out = swop.sw_chain(dq, 2, swop.tvdrk3_abc(30.0), con, topology, base=base, plain=True)
    assert swop.plain_calls - calls == 6
    assert torch.equal(out, swop.sw_run(dq, 2, swop.tvdrk3_abc(30.0), con, topology, base=base))


@pytest.mark.parametrize("form", ["absolute", "perturbation"])
def test_tvdrk3_chain_matches_jax(form):
    nel, s, dt, nsteps = 4, 3, 30.0, 3
    geom = j_make_cubed_sphere_2d(nel, s)
    ops, metric = j_make_dfr_operators(s), j_make_metric_2d(geom)
    q0 = np.asarray(case6_inputs(nel, s, torch.float64, "cpu")[3])
    pert = form == "perturbation"
    q = q0 + sw_delta(q0) if pert else q0
    jr = j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla",
                    **({"perturbation_base": jnp.asarray(q0)} if pert else {}))
    jint, qj = JTvdrk3(jr), jnp.asarray(q)
    for _ in range(nsteps):
        qj = jint.step(qj, dt)
    want = np.asarray(qj)

    rhs = interop.shallow_water_rhs(geom, ops, metric, **({"perturbation_base": q0} if pert else {}))
    integ, qt = Tvdrk3(rhs), interop.to_tensor(q)
    for _ in range(nsteps):
        qt = integ.step(qt, dt)
    assert integ._cache[2] is None  # no traces ride along the chain
    assert _scaled(interop.to_numpy(qt), want) < 1e-11
