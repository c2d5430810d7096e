"""The port's shallow-water tile-parallel path against the JAX package, on
the CPU, where the tile wrapper runs its plain version.

* ``build_tile_tables`` against the neighbour relation composed from the
  JAX ``_build_tile_tables`` (its interior shift rounds, edge-colour rounds,
  one-hot sends, routes, flips and rotations) at N = 1, 2, 3: the same
  neighbour tile and side, flip and 2x2 rotation for every tile and side.
* The plain tile operator against ``km_tile`` in interpret mode on one
  tile's operands (packed as the JAX tile step packs them, turned into the
  port's tensors by ``interop``), float64, case 6 at nel = 8, s = 3, the
  tile with two panel edges and two edges inside the panel: the absolute
  and the perturbation form, RHS and stages with a = 0 and a != 0, output
  and emitted edge traces within 1e-12 of scale (per variable, the larger
  of the output max and |cdt| times the flux-divergence max).
* The port's tile step at N = 1 and 2, absolute and perturbation form,
  against the JAX ``make_shard_map_sw_step_fused`` on the virtual CPU
  devices at the JAX test's size (tests/test_shard_map_fused.py: nel = 8,
  s = 3, dt = 30, two steps), within 1e-10 of scale, the JAX test's
  criterion; and against the port's own global chain (``Tvdrk3``), where
  it agrees to round-off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops import pallas_sw_gen as psg
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.parallel.shard_map_sw import _build_tile_tables
from wxfactory_tpu.parallel.shard_map_sw_fused import (
    _sw_base_interfaces_f64,
    _TileMetricView,
    make_shard_map_sw_step_fused as j_step_fused,
)
from wxfactory_tpu.parallel.topology import CubedSphereTopology as JTopology
from wxfactory_tpu.testcases import williamson_case6
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.integrators import Tvdrk3
from wxfactory_tpu_torch.kernels.check import sw_delta
from wxfactory_tpu_torch.parallel import CubedSphereTopology, TileMesh
from wxfactory_tpu_torch.parallel.exchange import TileExchange
from wxfactory_tpu_torch.parallel.mesh import tile_index, tile_view
from wxfactory_tpu_torch.parallel.shard_map_sw import build_tile_tables
from wxfactory_tpu_torch.parallel.shard_map_sw_fused import make_shard_map_sw_step_fused
from wxfactory_tpu_torch.ops import sw_operator as swop

torch.set_num_threads(1)

NEL, S, DT = 8, 3, 30.0


def _setup(nel, s):
    geom = make_cubed_sphere_2d(nel, s)
    return geom, make_dfr_operators(s), make_metric_2d(geom), williamson_case6(geom)


def _scale(a):
    return np.abs(a).reshape(a.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (a.ndim - 1))


def jax_relation(topology, n, s):
    """(nb_tile, nb_side, flip, conv) composed from the JAX tables: a tile's
    side-d halo comes from round route[t, d]; interior round r (0..3) is the
    cyclic shift that carries every tile's side-r trace, edge round 4 + c
    carries the side that ``onehot_send`` selects in colour c."""
    shift_perms, color_perms, onehot_send, route, flip, conv = _build_tile_tables(topology, n, s)
    ntile = 6 * n * n
    route, onehot_send = route.reshape(ntile, 4), onehot_send.reshape(ntile, 4, 4)
    nb_tile = np.zeros((ntile, 4), np.int64)
    nb_side = np.zeros((ntile, 4), np.int64)
    for t in range(ntile):
        for d in range(4):
            r = int(route[t, d])
            perm = shift_perms[r] if r < 4 else color_perms[r - 4]
            src = [a for a, b in perm if b == t]
            assert len(src) == 1
            nb_tile[t, d] = src[0]
            nb_side[t, d] = r if r < 4 else int(np.argmax(onehot_send[src[0], r - 4]))
    return nb_tile, nb_side, flip.reshape(ntile, 4) > 0.5, conv.reshape((ntile, 4) + conv.shape[4:])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_tile_tables_match_jax(n):
    geom, _, _, _ = _setup(6, S)
    nb_tile, nb_side, flip, conv = jax_relation(JTopology(geom), n, S)
    tables = build_tile_tables(CubedSphereTopology(geom), n, S)
    np.testing.assert_array_equal(tables.nb_tile, nb_tile)
    np.testing.assert_array_equal(tables.nb_side, nb_side)
    np.testing.assert_array_equal(tables.flip, flip)
    np.testing.assert_allclose(tables.conv, conv, rtol=0, atol=1e-14)
    # The relation is an involution: side d of t feeds side e of u exactly
    # when side e of u feeds side d of t.
    for t in range(6 * n * n):
        for d in range(4):
            u, e = tables.nb_tile[t, d], tables.nb_side[t, d]
            assert (tables.nb_tile[u, e], tables.nb_side[u, e]) == (t, d)


# ---------------------------------------------------------------------------
# The plain tile operator against km_tile in interpret mode

N_TILE = 2
TILE = (1, 1, 0)  # panel 1's north-west tile: north and west are panel edges


@pytest.fixture(scope="module")
def tile_case():
    """One tile's operands in both packages' forms: the JAX packed state,
    halo rows, tile constants and base planes (as the JAX tile step builds
    them), and the same values as numpy."""
    geom, ops, metric, q0 = _setup(NEL, S)
    nt = NEL // N_TILE
    p, ty, tx = TILE
    ey0, ex0 = ty * nt, tx * nt
    plan = psg.plan(S, nt)
    prows, used, rpr, npl, npts = plan.prows, plan.g * S * S, plan.rpr, plan.npl, nt * S
    c = psg.build_constants(ops, _TileMetricView(metric, ey0, ex0, nt), nt, S, dtype=jnp.float64,
                            single_block=True)
    con = psg.GenConstants(
        fields=tuple(c.fields[k][:prows] for k in range(13)), gridrot=c.gridrot[p * prows : (p + 1) * prows],
        **{name: getattr(c, name)[:prows] if name in ("m_sg", "m_hd", "m_ho") else getattr(c, name)
           for name in psg._CON_FIELDS},
    )

    def pack(qt, pad_h):  # (V, nt, nt, s^2) -> (V, prows, 128), as the JAX tile step's pack_tile
        v = qt.shape[0]
        pad = np.zeros((v, nt, rpr, 128 - used))
        if pad_h:
            pad[0] = 1.0
        return jnp.asarray(np.concatenate([qt.reshape(v, nt, rpr, used), pad], -1).reshape(v, prows, 128))

    def rows(halo):  # port-side halo (3, 4, 1, nt, s) values -> km_tile's (1, 3, npl) rows W, E, S, N
        flat = np.asarray(halo).reshape(3, 4, npts)
        return [jnp.asarray(np.pad(flat[:, d], ((0, 0), (0, npl - npts)))[None]) for d in (2, 3, 0, 1)]

    # Inputs: a noisy state and a perturbation, their tile halos from the
    # port's tile exchange (plain glue on the CPU).
    rng = np.random.default_rng(3)
    q = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    x = q0 * (1.0 + 1e-3 * rng.standard_normal(q0.shape))
    dq, dx = sw_delta(q0), 1e-3 * q0 * rng.standard_normal(q0.shape)
    topology = CubedSphereTopology(geom)
    mesh = TileMesh(N_TILE)
    exchange = TileExchange(build_tile_tables(topology, N_TILE, S), mesh, (3, 4, 1, nt, S), (1, nt, 1, S))
    pcon = swop.build_constants(ops, metric, NEL)
    k = tile_index(*TILE, N_TILE)

    def halo_of(state):
        t = interop.to_tensor(state)
        traces = [swop.tile_edge_traces(tile_view(t, *pos, nt).contiguous(), pcon) for pos in mesh.tiles()]
        return exchange(traces)[k].numpy()

    tile = lambda a: np.asarray(a)[:, p, ey0 : ey0 + nt, ex0 : ex0 + nt]
    # Base planes (shard_map_sw_fused.py:205-260 of the JAX package).
    q0j = jnp.asarray(q0)
    rhs0 = np.asarray(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla")(q0j))
    qL_x, qR_x, qL_y, qR_y = (np.asarray(a) for a in _sw_base_interfaces_f64(geom, ops, JTopology(geom), q0j))
    padf = lambda a: jnp.asarray(np.pad(a, ((0, 0), (0, npl - npts))))
    hw0 = padf(qL_x[:, p, ey0 : ey0 + nt, ex0, :].reshape(3, npts))
    he0 = padf(qR_x[:, p, ey0 : ey0 + nt, ex0 + nt, :].reshape(3, npts))
    hs0 = padf(qL_y[:, p, ey0, ex0 : ex0 + nt, :].reshape(3, npts))
    hn0 = padf(qR_y[:, p, ey0 + nt, ex0 : ex0 + nt, :].reshape(3, npts))
    q0t = pack(tile(q0), True)
    a0 = jnp.stack([q0t[v] @ c.eexy for v in range(3)])
    e0 = jnp.stack([psg._expand_halo(hw0[v : v + 1], he0[v : v + 1], hs0[v : v + 1], hn0[v : v + 1], c,
                                     jnp.float64) for v in range(3)])
    bp = jnp.concatenate([q0t, pack(tile(q0[1:3] / q0[0]), False), a0, e0, pack(tile(rhs0), False)])
    return {
        "nt": nt, "g": plan.g, "con": con, "pcon": swop.build_tile_constants(ops, metric, ey0, ex0, nt, p),
        "abs": (pack(tile(q), True), pack(tile(x), True), rows(halo_of(q))),
        "pert": (pack(tile(dq), False), pack(tile(dx), False), rows(halo_of(dq))),
        "bp": bp, "base_rows": [r[None] for r in (hw0, he0, hs0, hn0)],
        "term": _flux_div(tile(q), swop.tile_constants(pcon, ey0, ex0, nt, p)),
    }


def _flux_div(qt, pcon):
    from wxfactory_tpu_torch.kernels.check import flux_divergence_scale

    return flux_divergence_scale(interop.to_tensor(qt[:, None]), pcon).numpy()


MODES = {"rhs": {}, "stage": dict(stage_a=0.0, stage_b=1.0, cdt=DT),
         "stage_x": dict(stage_a=0.75, stage_b=0.25, cdt=0.25 * DT)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("form", ["abs", "pert"])
def test_tile_plain_matches_km_tile(tile_case, form, mode):
    c = tile_case
    nt, g = c["nt"], c["g"]
    qp, xp, (hw, he, hs, hn) = c[form]
    kw = MODES[mode]
    stage = bool(kw)
    bp = c["bp"] if form == "pert" else None
    out = psg.km_tile(qp, hw, he, hs, hn, c["con"], nt, S, x=xp if stage else None, emit_slabs=stage,
                      interpret=True, bp=bp, **kw)
    base = interop.sw_tile_base(bp, *c["base_rows"], c["pcon"], nt, S, g) if bp is not None else None
    q = interop.sw_tile_state(qp, nt, S, g)
    halo = interop.sw_tile_halo(hw, he, hs, hn, nt, S)
    port_kw = dict(x=interop.sw_tile_state(xp, nt, S, g), a=kw["stage_a"], b=kw["stage_b"], cdt=kw["cdt"],
                   emit_traces=True) if stage else {}
    got = swop.sw_tile_operator(q, halo, c["pcon"], base=base, **port_kw)
    if stage:
        (got, got_tr), (out, we, ssl, nsl) = got, out
        want_tr = interop.to_numpy(interop.sw_tile_traces(we, ssl, nsl, nt, S, g))
        tr = interop.to_numpy(got_tr)
        assert np.abs((tr - want_tr) / _scale(want_tr)).max() < 1e-12
    want = interop.to_numpy(interop.sw_tile_state(out, nt, S, g))
    got = interop.to_numpy(got)
    cdt = abs(kw.get("cdt", 1.0))
    scale = np.maximum(_scale(want), cdt * c["term"].reshape(3, 1, 1, 1, 1))
    assert np.abs((got - want) / scale).max() < 1e-12


# ---------------------------------------------------------------------------
# The tile step against the JAX fused tile step and the port's global chain


@pytest.fixture(scope="module")
def sw_case():
    return _setup(NEL, S)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("pert", [False, True], ids=["absolute", "perturbation"])
def test_tile_step_matches_jax_fused_and_global(sw_case, n, pert):
    geom, ops, metric, q0 = sw_case
    ndev = 6 * n * n
    mesh = Mesh(np.array(jax.devices()[:ndev]).reshape(6, n, n), ("panel", "y", "x"))
    jstep, sharding = j_step_fused(geom, ops, metric, mesh, DT, dtype=jnp.float64,
                                   perturbation_base=(jnp.asarray(q0) if pert else None))
    want = np.asarray(jstep(jstep(jax.device_put(jnp.asarray(q0), sharding))))

    base = q0 if pert else None
    step = make_shard_map_sw_step_fused(geom, ops, metric, TileMesh(n), DT, dtype=torch.float64,
                                        perturbation_base=base, device="cpu")
    swop.tile_launches = swop.pert_tile_launches = 0
    got = interop.to_numpy(step(step(interop.to_tensor(q0))))
    assert np.abs((got - want) / _scale(want)).max() < 1e-10

    rhs = interop.shallow_water_rhs(geom, ops, metric, perturbation_base=base)
    integ, q = Tvdrk3(rhs), interop.to_tensor(q0)
    for _ in range(2):
        q = integ.step(q, DT)
    chain = interop.to_numpy(q)
    assert np.abs((got - chain) / _scale(chain)).max() < 1e-13
