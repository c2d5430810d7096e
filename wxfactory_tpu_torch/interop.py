"""Hand the JAX package's host data to the port.

The JAX package builds its setup objects (``DFROperators``, ``Metric2D``,
``Metric3D``, ``CubedSphere2D``, ``CubedSphere3D``, ``Cartesian2D``, initial states) in float64 numpy with the same code the
port carries, so the port's setup functions accept them as they are. These helpers
turn them into the port's tensors and constant structs on a given device,
so a test can drive both packages from identical inputs. Nothing here
imports JAX: arrays arrive as numpy (``np.asarray`` of a JAX array).

The tile kernels' operands (``pallas_sw_gen.km_tile``,
``pallas_euler3d.km3_tile``) come in the TPU's packed lane layouts; the
``*_tile_*`` helpers invert those packings into the port's tile tensors
(state, halos, emitted traces, base planes), given the packing's numbers
(elements a row ``g``, and for 3D the y-slot lane offset) that the JAX
package's ``plan``/``tile_plan`` chose.
"""

import numpy as np
import torch

from .models.euler_cartesian import EulerCartesianRHS
from .models.euler_cubesphere import Euler3DAdvectionRHS, Euler3DRHS, RayleighDamping
from .models.shallow_water import ShallowWaterRHS, Topography
from .ops import euler3d_operator
from .ops.sw_operator import SWConstants, SWPertBase, SWTopography, build_constants, build_topography


def to_tensor(a, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """A numpy array (or anything ``np.asarray`` takes) as a tensor."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(a)), dtype=dtype, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def sw_constants(ops, metric, nel: int, device="cpu", dtype=torch.float64) -> SWConstants:
    """The SW operator's constants from DFR operators and a 2D metric."""
    return build_constants(ops, metric, nel, dtype=dtype, device=device)


def sw_topography_fields(topo) -> Topography:
    """The port's host ``Topography`` of either package's (numpy copies of
    its five fields)."""
    return Topography(**{k: np.asarray(getattr(topo, k), np.float64)
                         for k in ("hsurf", "hsurf_itf_x1", "hsurf_itf_x2", "dzdx1", "dzdx2")})


def sw_topography(topo, metric, device="cpu", dtype=torch.float64) -> SWTopography:
    """The SW operator's topography planes from either package's
    ``Topography`` (numpy arrays) and a 2D metric."""
    return build_topography(sw_topography_fields(topo), metric, dtype=dtype, device=device)


def shallow_water_rhs(geom, ops, metric, device="cpu", dtype=torch.float64,
                      perturbation_base=None, topo=None) -> ShallowWaterRHS:
    """The port's SW RHS on a geometry, operators and metric built by
    either package (``perturbation_base``: the base state q0 of the
    perturbation form, a numpy array as the JAX factory takes it; ``topo``:
    either package's ``Topography``)."""
    return ShallowWaterRHS(geom, ops, metric, dtype=dtype, device=device, perturbation_base=perturbation_base,
                           topo=None if topo is None else sw_topography_fields(topo))


def rayleigh_damping(extra_forcing) -> RayleighDamping:
    """The port's ``RayleighDamping`` of the JAX package's DCMIP 21/22
    damping, a closure ``extra_forcing(rho, u1, u2, w)`` over its planes
    (``wxfactory_tpu/testcases/dcmip.py::make_schar_damping``: ``mask_j``,
    ``u1ref_j``, ``u2ref_j``, ``u3ref_j``), read from the closure's cells."""
    cells = dict(zip(extra_forcing.__code__.co_freevars, (c.cell_contents for c in extra_forcing.__closure__)))
    plane = lambda name: np.asarray(cells[name], np.float64)
    return RayleighDamping(mask=plane("mask_j"), u1ref=plane("u1ref_j"), u2ref=plane("u2ref_j"),
                           u3ref=plane("u3ref_j"))


def euler3d_constants(ops, metric, nel_h: int, nel_v: int, device="cpu", dtype=torch.float64,
                      geom=None, damping=None) -> euler3d_operator.E3Constants:
    """The 3D Euler operator's constants from 3D DFR operators and a 3D
    metric; with ``geom`` (a geometry with topography) every panel's metric,
    with ``damping`` (a ``RayleighDamping``) the Rayleigh sponge."""
    panel_metric = geom is not None and euler3d_operator.has_topography(geom)
    return euler3d_operator.build_constants(ops, metric, nel_h, nel_v, dtype=dtype, device=device,
                                            panel_metric=panel_metric, damping=damping)


def euler3d_rhs(geom, ops, metric, device="cpu", dtype=torch.float64, base_state=None,
                perturbation_base=None, damping=None, advection_only: bool = False):
    """The port's 3D Euler RHS on a geometry, operators and metric built by
    either package, terrain included (``base_state``: the well-balanced
    offset's state; ``perturbation_base``: the base state q0 of the
    perturbation form, a numpy array as the JAX factory takes it;
    ``damping``: the Rayleigh sponge of DCMIP 21/22, a ``RayleighDamping``;
    ``rayleigh_damping`` reads the JAX package's). With ``advection_only``
    (DCMIP 11/12, as the JAX factory's flag) the tracer-advection RHS
    ``Euler3DAdvectionRHS``: ``base_state`` and ``damping`` are ignored there
    as the JAX factory ignores them (the momentum rows are zeroed), and
    ``perturbation_base`` is refused, as it refuses it."""
    if advection_only:
        if perturbation_base is not None:
            raise ValueError("perturbation_base supports the plain 5-variable system")
        return Euler3DAdvectionRHS(geom, ops, metric, dtype=dtype, device=device)
    return Euler3DRHS(geom, ops, metric, dtype=dtype, device=device, base_state=base_state,
                      perturbation_base=perturbation_base, damping=damping)


def euler_cartesian_rhs(geom, ops, device="cpu", dtype=torch.float64) -> EulerCartesianRHS:
    """The port's 2D Cartesian DFR RHS on a ``Cartesian2D`` and
    ``DFROperators`` built by either package (the JAX factory's
    ``make_rhs_euler_cartesian(geom, ops, dtype)``). The JAX package's
    state (4, nel_z, nel_x, s^2) is the port's layout: ``to_tensor`` carries
    it over with no relayout."""
    return EulerCartesianRHS(geom, ops, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Tile operands of the TPU tile kernels


def sw_tile_state(qp, nt: int, s: int, g: int, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """A packed SW tile (3 or more planes, (nt * nt/g) rows, 128 lanes; g
    elements a row, as the tile step's ``pack_tile``) -> (V, 1, nt, nt, s^2)."""
    qp = np.asarray(qp)
    b = qp.reshape(qp.shape[0], nt, nt // g, 128)[..., : g * s * s]
    return to_tensor(b.reshape(qp.shape[0], 1, nt, nt, s * s), device, dtype)


def sw_tile_halo(hw, he, hs, hn, nt: int, s: int, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """km_tile's flat halo rows, each (1, 3, npl), -> the port's tile halo
    (3, 4, 1, nt, s) in (S, N, W, E) order."""
    rows = np.stack([np.asarray(h)[0, :, : nt * s] for h in (hs, hn, hw, he)], axis=1)
    return to_tensor(rows.reshape(3, 4, 1, nt, s), device, dtype)


def sw_tile_traces(we, ssl, nsl, nt: int, s: int, g: int, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """km_tile's emitted edge slabs (west/east, south, north) -> the tile's
    edge traces (3, 4, 1, nt, s) in (S, N, W, E) order (the slab reading of
    the JAX tile step's ``_traces_from_slabs``)."""
    we, ssl, nsl = np.asarray(we), np.asarray(ssl), np.asarray(nsl)
    npts, rpr = nt * s, nt // g
    west = we[:, :nt, 0:s].reshape(3, npts)
    east = we[:, :nt, s : 2 * s].reshape(3, npts)
    south = ssl[:, :rpr, : g * s].reshape(3, npts)
    north = nsl[:, :rpr, : g * s].reshape(3, npts)
    return to_tensor(np.stack([south, north, west, east], axis=1).reshape(3, 4, 1, nt, s), device, dtype)


def sw_tile_base(bp, hw0, he0, hs0, hn0, con: SWConstants, nt: int, s: int, g: int) -> SWPertBase:
    """km_tile's 14 base planes ``bp`` (q0, u0, base traces, expanded base
    halos, base RHS) with the base halo rows they were expanded from ->
    the port's tile base: q0, u0 and rhs0 unpacked, the face traces
    q0 @ EE in ``con``'s dtype, the base halo from the rows."""
    planes = sw_tile_state(bp, nt, s, g, con.device, con.dtype)
    q0 = planes[0:3].contiguous()
    return SWPertBase(q0=q0, u0=planes[3:5].contiguous(), itf0=(q0 @ con.ee).contiguous(),
                      halo0=sw_tile_halo(hw0, he0, hs0, hn0, nt, s, con.device, con.dtype),
                      rhs0=planes[11:14].contiguous())


def euler3d_tile_state(qp, nt: int, nk: int, s: int, g: int, device="cpu", dtype=torch.float64) -> torch.Tensor:
    """A packed 3D tile (5, Rp, 128) (``pack_tile_jnp``) -> (5, 1, nk, nt,
    nt, s^3) (``unpack_tile_jnp`` with the panel axis kept)."""
    qp = np.asarray(qp)
    rows, s3 = nt * nk * (nt // g), s**3
    b = qp[:, :rows, : g * s3].reshape(5, nt, nk, nt, s3)
    return to_tensor(np.moveaxis(b, 1, 2)[:, None], device, dtype)


def euler3d_tile_halo(hwe, hs, hn, nt: int, nk: int, s: int, g: int, y_offset: int, device="cpu",
                      dtype=torch.float64) -> torch.Tensor:
    """km3_tile's formatted halos (``format_tile_halos``: hwe (5, nt*nk,
    128) rows (ky, kz) with west faces at lanes [0, s^2) and east at [T -
    s^2, T), T = 2 g s^2; hs/hn (5, nk*nt/g, 128) with element gg's faces at
    lanes y_offset + 2 gg s^2, north ones s^2 further) -> the port's tile
    halo (5, 4, 1, nk, nt, s^2) in (S, N, W, E) order."""
    hwe, hs, hn = np.asarray(hwe), np.asarray(hs), np.asarray(hn)
    ss, t = s * s, 2 * g * s * s
    we = lambda lanes: np.swapaxes(hwe[:, : nt * nk, lanes].reshape(5, nt, nk, ss), 1, 2)
    lanes = lambda off: np.concatenate([y_offset + 2 * gg * ss + off + np.arange(ss) for gg in range(g)])
    sn = lambda h, off: h[:, : nk * (nt // g), lanes(off)].reshape(5, nk, nt, ss)
    sides = [sn(hs, 0), sn(hn, ss), we(slice(0, ss)), we(slice(t - ss, t))]
    return to_tensor(np.stack(sides, axis=1)[:, :, None], device, dtype)


def euler3d_tile_we_traces(we, nt: int, nk: int, s: int, g: int, device="cpu", dtype=torch.float64):
    """km3_tile's emitted west/east slabs (5, tynk_pad, 128) -> (west,
    east) traces, each (5, nk, nt, s^2) (the JAX tile step's
    ``we_from_slabs``)."""
    we = np.asarray(we)
    ss, t = s * s, 2 * g * s * s
    rows = we[:, : nt * nk].reshape(5, nt, nk, 128)
    side = lambda lanes: to_tensor(np.swapaxes(rows[..., lanes], 1, 2), device, dtype)
    return side(slice(0, ss)), side(slice(t - ss, t))


def euler3d_tile_base(q0p, rhs0p, hwe0, hs0, hn0, like: euler3d_operator.E3PertBase, nt: int, nk: int, s: int,
                      g: int, y_offset: int) -> euler3d_operator.E3PertBase:
    """km3_tile's perturbation base {q0, rhs0, hwe0, hs0, hn0} (packed and
    formatted as its state and halos) -> the port's tile base: ``like`` (a
    tile base from ``tile_pert_base`` on the same base state, for the fields
    only the plain version reads) with q0, rhs0 and the base halo taken from
    the JAX operands."""
    import dataclasses

    dev, dt = like.q0.device, like.q0.dtype
    return dataclasses.replace(
        like, q0=euler3d_tile_state(q0p, nt, nk, s, g, dev, dt), rhs0=euler3d_tile_state(rhs0p, nt, nk, s, g, dev, dt),
        halo0=euler3d_tile_halo(hwe0, hs0, hn0, nt, nk, s, g, y_offset, dev, dt),
    )
