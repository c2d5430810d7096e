"""The port's 3D Euler tile-parallel path against the JAX package, on the
CPU, where the tile wrapper runs its plain version.

* The plain tile operator against ``km3_tile`` in interpret mode on one
  tile's operands (packed and formatted as the JAX tile step does, turned
  into the port's tensors by ``interop``), float64, dcmip31 at 4x3, s = 2,
  N = 2, the tile with two panel edges and two edges inside the panel, and
  the rotating planet of ``acoustic_wave`` (time Christoffels of the tile's
  own panel; its stage with a != 0): the absolute and the perturbation
  form, RHS and stages with a = 0 and a != 0, outputs within 1e-12 of scale (per variable, the larger
  of the output max and |cdt| times the RHS term scale) and the emitted
  west/east traces (the sides km3_tile emits) within 1e-12 of their max,
  1e-11 for the perturbation form's delta traces (the bound of
  tests/test_torch_euler3d_pert_stage.py: the JAX kernel writes log1p and
  expm1 as compensated formulas).
* The port's tile step against the JAX ``make_shard_map_euler3d_step_fused``
  on the virtual CPU devices at the JAX test's size (4x3, s = 2, dt = 1,
  two steps): N = 2 absolute and perturbation, N = 1 absolute, and the
  rotating planet at N = 2 in the perturbation form (the JAX test's case);
  within 1e-10 of scale, the JAX test's criterion. The same steps, and N = 1
  in both forms on both planets, against the port's own global chain
  (``Tvdrk3``), to round-off.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from wxfactory_tpu.models import make_rhs_euler_cubesphere as j_make_rhs
from wxfactory_tpu.ops import pallas_euler3d as pe3
from wxfactory_tpu.parallel.shard_map_euler3d_fused import (
    _global_base_traces,
    _panel_edge_base_halos,
    _TileMetric3DView,
    make_shard_map_euler3d_step_fused as j_step_fused,
)
from wxfactory_tpu.testcases import dcmip_gravity_wave
from wxfactory_tpu.testcases.dcmip import acoustic_wave
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.integrators import Tvdrk3
from wxfactory_tpu_torch.kernels.check import euler3d_term_scale
from wxfactory_tpu_torch.ops import euler3d_operator as e3op
from wxfactory_tpu_torch.parallel import CubedSphereTopology, TileMesh
from wxfactory_tpu_torch.parallel.exchange import TileExchange
from wxfactory_tpu_torch.parallel.mesh import tile_index, tile_view
from wxfactory_tpu_torch.parallel.shard_map_euler3d_fused import make_shard_map_euler3d_step_fused
from wxfactory_tpu_torch.parallel.shard_map_sw import build_tile_tables

torch.set_num_threads(1)

NEL_H, NEL_V, S, DT = 4, 3, 2, 1.0


def _setup(rotating: bool):
    from conftest import cs3d_setup

    if rotating:
        geom, ops, topo, metric = cs3d_setup(NEL_H, NEL_V, S, 10000.0, scale=1.0, rotating=True)
        return geom, ops, topo, metric, acoustic_wave(geom)
    geom, ops, topo, metric = cs3d_setup(NEL_H, NEL_V, S, 10000.0)
    return geom, ops, topo, metric, dcmip_gravity_wave(geom)


def _scale(a):
    return np.abs(a).reshape(a.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (a.ndim - 1))


# ---------------------------------------------------------------------------
# The plain tile operator against km3_tile in interpret mode

N_TILE = 2
TILE = (1, 1, 0)  # panel 1's north-west tile: north and west are panel edges


@functools.lru_cache(maxsize=None)
def _tile_case(rotating: bool):
    geom, ops, jtopo, metric, q0 = _setup(rotating)
    nt, nk = NEL_H // N_TILE, NEL_V
    p, ty, tx = TILE
    ey0, ex0 = ty * nt, tx * nt
    g, nxp, rows, rp = pe3.tile_plan(nt, nk, S)
    y_offset = 0 if pe3.is_split_layout(S, g) else 64
    c = pe3.build_constants(ops, _TileMetric3DView(metric, ey0, ex0, nt), nt, nk, S, dtype=jnp.float64, g=g)
    tch = c.tch
    con = pe3.pad_tile_constants(c._replace(tch=None), nt, nk, S)
    if tch is not None:
        pad = lambda a: jnp.concatenate([a, jnp.zeros((rp - rows, 128), a.dtype)], 0)
        con = con._replace(tch=tuple(pad(a[p * rows : (p + 1) * rows]) for a in tch))
    mats = pe3.tile_halo_mats(nt, nk, S, jnp.float64)
    tile = lambda a: np.asarray(a)[:, p, :, ey0 : ey0 + nt, ex0 : ex0 + nt]
    pack = lambda a, fill: pe3.pack_tile_jnp(jnp.asarray(tile(a)), nt, nk, S, state_fill=fill)

    # Inputs: noisy states and perturbations; their tile halos from the
    # port's tile exchange (plain glue on the CPU), formatted for km3_tile.
    rng = np.random.default_rng(5)
    q = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    q[3] += 0.1 * q0[0] * rng.standard_normal(q0[0].shape)
    x = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    dq, dx = (1e-4 * q0 * rng.standard_normal(q0.shape) for _ in range(2))
    topology = CubedSphereTopology(geom)
    mesh = TileMesh(N_TILE)
    pcon = e3op.build_constants(ops, metric, NEL_H, NEL_V)
    cons = [e3op.tile_constants(pcon, y * nt, x_ * nt, nt, pp) for pp, y, x_ in mesh.tiles()]
    base64 = e3op.build_pert_base(interop.to_tensor(q0), pcon, topology, torch.float64)
    perts = [e3op.tile_pert_base(base64, y * nt, x_ * nt, nt, pp, torch.float64) for pp, y, x_ in mesh.tiles()]
    exchange = TileExchange(build_tile_tables(topology, N_TILE, S), mesh, (5, 4, 1, nk, nt, S * S), (nk, nt, S, S))
    k = tile_index(*TILE, N_TILE)

    def halo_of(state, pert):
        t = interop.to_tensor(state)
        traces = [e3op.tile_edge_traces(tile_view(t, *pos, nt).contiguous(), cons[i], perts[i] if pert else None)
                  for i, pos in enumerate(mesh.tiles())]
        h = exchange(traces)[k].numpy()[:, :, 0]  # (5, 4, nk, nt, ss): S, N, W, E
        return pe3.format_tile_halos(*(jnp.asarray(h[:, d]) for d in (2, 3, 0, 1)), nt, nk, S, mats)

    # The JAX tile base (shard_map_euler3d_fused.py:260-306).
    q0j = jnp.asarray(q0)
    rhs0 = np.asarray(j_make_rhs(geom, ops, metric, topology=jtopo, dtype=jnp.float64, interior="xla")(q0j))
    t_x, t_y = _global_base_traces(q0j, ops)
    halo0 = np.asarray(_panel_edge_base_halos(t_x, t_y, jtopo, S))
    t_x, t_y, ss = np.asarray(t_x), np.asarray(t_y), S * S
    w0 = halo0[:, 2, p, :, ey0 : ey0 + nt] if tx == 0 else t_x[:, p, :, ey0 : ey0 + nt, ex0 - 1, ss:]
    e0 = halo0[:, 3, p, :, ey0 : ey0 + nt] if tx == N_TILE - 1 else t_x[:, p, :, ey0 : ey0 + nt, ex0 + nt, :ss]
    s0 = halo0[:, 0, p, :, ex0 : ex0 + nt] if ty == 0 else t_y[:, p, :, ey0 - 1, ex0 : ex0 + nt, ss:]
    n0 = halo0[:, 1, p, :, ex0 : ex0 + nt] if ty == N_TILE - 1 else t_y[:, p, :, ey0 + nt, ex0 : ex0 + nt, :ss]
    hwe0, hs0, hn0 = pe3.format_tile_halos(*(jnp.asarray(a) for a in (w0, e0, s0, n0)), nt, nk, S, mats)
    base = {"q0": pack(q0, True), "rhs0": pack(rhs0, False), "hwe0": hwe0, "hs0": hs0, "hn0": hn0}
    pbase = interop.euler3d_tile_base(base["q0"], base["rhs0"], hwe0, hs0, hn0, perts[k], nt, nk, S, g, y_offset)
    return {
        "dims": (nt, nk, S, g), "y_offset": y_offset, "con": con,
        "pcon": e3op.build_tile_constants(ops, metric, ey0, ex0, nt, p), "base": base, "pbase": pbase,
        "abs": (pack(q, True), pack(x, True), halo_of(q, False)),
        "pert": (pack(dq, False), pack(dx, False), halo_of(dq, True)),
        "term": euler3d_term_scale(tile_view(interop.to_tensor(q), *TILE, nt), cons[k]).numpy(),
    }


MODES = {"rhs": {}, "stage": dict(stage_a=0.0, stage_b=1.0, cdt=0.1),
         "stage_x": dict(stage_a=0.75, stage_b=0.25, cdt=0.025)}


CASES = [(False, form, mode) for form in ("abs", "pert") for mode in MODES]
CASES += [(True, form, "stage_x") for form in ("abs", "pert")]  # the rotating planet's tch


@pytest.mark.parametrize("rotating,form,mode", CASES,
                         ids=[f"{'rotating' if r else 'dcmip31'}-{f}-{m}" for r, f, m in CASES])
def test_tile_plain_matches_km3_tile(rotating, form, mode):
    c = _tile_case(rotating)
    nt, nk, s, g = c["dims"]
    qp, xp, (hwe, hs, hn) = c[form]
    kw = MODES[mode]
    stage = bool(kw)
    pert = form == "pert"
    out = pe3.km3_tile(qp, hwe, hs, hn, c["con"], nt, nk, s, x=xp if stage else None, emit_slabs=stage,
                       interpret=True, base=c["base"] if pert else None, **kw)
    port_kw = dict(x=interop.euler3d_tile_state(xp, nt, nk, s, g), a=kw["stage_a"], b=kw["stage_b"],
                   cdt=kw["cdt"], emit_traces=True) if stage else {}
    got = e3op.euler3d_tile_operator(interop.euler3d_tile_state(qp, nt, nk, s, g),
                                     interop.euler3d_tile_halo(hwe, hs, hn, nt, nk, s, g, c["y_offset"]), c["pcon"],
                                     pert=c["pbase"] if pert else None, **port_kw)
    if stage:
        (got, got_tr), (out, we) = got, out
        # Delta traces: 1e-11, the bound of tests/test_torch_euler3d_pert_stage.py
        # (km3_tile writes log1p/expm1 as compensated formulas, the port
        # calls them, ~1 ulp of the small arguments apart).
        tol = 1e-11 if pert else 1e-12
        for side, want_tr in zip((2, 3), interop.euler3d_tile_we_traces(we, nt, nk, s, g)):
            want_tr = want_tr.numpy()
            tr = got_tr[:, side, 0].numpy()
            assert np.abs((tr - want_tr) / _scale(want_tr)).max() < tol
    want = interop.euler3d_tile_state(out, nt, nk, s, g).numpy()
    got = got.numpy()
    scale = np.maximum(_scale(want), abs(kw.get("cdt", 1.0)) * c["term"].reshape(5, 1, 1, 1, 1, 1))
    assert np.abs((got - want) / scale).max() < 1e-12


# ---------------------------------------------------------------------------
# The tile step against the JAX fused tile step and the port's global chain


def _port_steps(geom, ops, metric, q0, n, pert, nsteps=2):
    step = make_shard_map_euler3d_step_fused(geom, ops, metric, TileMesh(n), DT, dtype=torch.float64,
                                             perturbation_base=q0 if pert else None, device="cpu")
    q = interop.to_tensor(q0)
    for _ in range(nsteps):
        q = step(q)
    return q.numpy()


def _chain(geom, ops, metric, q0, pert, nsteps=2):
    rhs = interop.euler3d_rhs(geom, ops, metric, perturbation_base=q0 if pert else None)
    integ, q = Tvdrk3(rhs), interop.to_tensor(q0)
    for _ in range(nsteps):
        q = integ.step(q, DT)
    return q.numpy()


@pytest.mark.parametrize("rotating,n,pert", [(False, 2, False), (False, 2, True), (False, 1, False), (True, 2, True)],
                         ids=["dcmip31-N2-absolute", "dcmip31-N2-perturbation", "dcmip31-N1-absolute",
                              "rotating-N2-perturbation"])
def test_tile_step_matches_jax_fused(rotating, n, pert):
    geom, ops, _, metric, q0 = _setup(rotating)
    mesh = Mesh(np.array(jax.devices()[: 6 * n * n]).reshape(6, n, n), ("panel", "y", "x"))
    jstep, sharding = j_step_fused(geom, ops, metric, mesh, DT, dtype=jnp.float64,
                                   perturbation_base=(jnp.asarray(q0) if pert else None))
    want = np.asarray(jstep(jstep(jax.device_put(jnp.asarray(q0), sharding))))
    got = _port_steps(geom, ops, metric, q0, n, pert)
    assert np.abs((got - want) / _scale(want)).max() < 1e-10
    chain = _chain(geom, ops, metric, q0, pert)
    assert np.abs((got - chain) / _scale(chain)).max() < 1e-13


@pytest.mark.parametrize("rotating", [False, True], ids=["dcmip31", "rotating"])
@pytest.mark.parametrize("pert", [False, True], ids=["absolute", "perturbation"])
@pytest.mark.parametrize("n", [1, 2])
def test_tile_step_matches_global_chain(rotating, pert, n):
    geom, ops, _, metric, q0 = _setup(rotating)
    e3op.tile_launches = e3op.pert_tile_launches = 0
    got = _port_steps(geom, ops, metric, q0, n, pert, nsteps=3)
    chain = _chain(geom, ops, metric, q0, pert, nsteps=3)
    assert np.abs((got - chain) / _scale(chain)).max() < 1e-13
