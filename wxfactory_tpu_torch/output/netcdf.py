"""NetCDF field output of cubed-sphere runs.

Counterpart of ``wxfactory_tpu/output/netcdf.py`` (the reference's
output/output_cubesphere_netcdf.py): one file, lat/lon grids a panel, and
the same variables, dimensions and units: shallow water writes h (the total
height over the topography), U, V (m/s), RV and PV (relative and potential
vorticity); 3D Euler writes rho, U, V, W, theta, P (+ tracer mixing ratios
q1.. when the state carries them). The netCDF4 package when it is
installed, else ``scipy.io.netcdf_file`` (NetCDF3-classic: the same
variables and dimensions, no compression), so field output needs no
optional dependency.

The writer takes host arrays: the output manager reads the state from the
card once a write and hands it the numpy copy; the diagnostics (winds,
vorticities, pressure) are computed on the host in float64, as the JAX
package computes them.
"""

from typing import Optional

import numpy as np

try:
    import netCDF4  # noqa: F401

    _BACKEND = "netcdf4"
except ImportError:
    try:
        from scipy.io import netcdf_file  # noqa: F401

        _BACKEND = "scipy"
    except ImportError:  # pragma: no cover - scipy is a dependency elsewhere
        _BACKEND = None

HAVE_NETCDF = _BACKEND is not None


class _Nc4File:
    def __init__(self, path):
        import netCDF4 as nc

        self.f = nc.Dataset(path, "w", format="NETCDF4")

    def dim(self, name, size):
        self.f.createDimension(name, size)

    def var(self, name, dims):
        return self.f.createVariable(name, "f8", dims)

    def sync(self):
        self.f.sync()

    def close(self):
        self.f.close()


class _ScipyNcFile:
    """NetCDF3-classic writer on scipy.io.netcdf_file."""

    def __init__(self, path):
        from scipy.io import netcdf_file

        self.f = netcdf_file(path, "w")

    def dim(self, name, size):
        self.f.createDimension(name, size)

    def var(self, name, dims):
        return self.f.createVariable(name, "d", dims)

    def sync(self):
        self.f.flush()

    def close(self):
        self.f.close()


def _to_single_block_3d(a: np.ndarray, nel_v: int, nel_h: int, s: int) -> np.ndarray:
    """(6, nk, ny, nx, s^3) -> (nk*s, 6, ny*s, nx*s) plottable level blocks
    (node order (kz*s + ky)*s + kx, x fastest)."""
    b = np.asarray(a).reshape(6, nel_v, nel_h, nel_h, s, s, s)
    b = np.transpose(b, (1, 4, 0, 2, 5, 3, 6))  # (kz, zs, p, ky, ys, kx, xs)
    return b.reshape(nel_v * s, 6, nel_h * s, nel_h * s)


class NetCDFWriter:
    """The reference writer's variable set
    (output/output_cubesphere_netcdf.py:134-270 there): shallow water h
    (total height over the topography), U, V, RV, PV; 3D Euler rho, U, V,
    W, theta, P (+ tracers q1.. when the state carries them)."""

    def __init__(self, path: str, geom, metric, ops, equations: str, topo=None, num_tracers: int = 0):
        if not HAVE_NETCDF:
            raise RuntimeError("no NetCDF backend available; use output_format = none")
        self.geom = geom
        self.metric = metric
        self.ops = ops
        self.equations = equations
        self.topo = topo
        self.file = _Nc4File(path) if _BACKEND == "netcdf4" else _ScipyNcFile(path)

        self.is_3d = equations == "euler"
        s = geom.num_solpts
        nel_h = geom.nel_h if self.is_3d else geom.num_elements
        ni = nel_h * s
        f = self.file
        f.dim("time", None)
        f.dim("panel", 6)
        f.dim("Ydim", ni)
        f.dim("Xdim", ni)

        self.tvar = f.var("time", ("time",))
        self.tvar.units = "seconds since simulation start"

        if self.is_3d:
            f.dim("Zdim", geom.nel_v * s)
            lat2 = np.asarray(geom.lat)[:, 0].reshape(6, nel_h, nel_h, s, s, s)[..., 0, :, :]
            lon2 = np.asarray(geom.lon)[:, 0].reshape(6, nel_h, nel_h, s, s, s)[..., 0, :, :]
            block2 = lambda a: np.swapaxes(a, -2, -3).reshape(6, ni, ni)
            grid_dims = ("time", "Zdim", "panel", "Ydim", "Xdim")
            names = ["rho", "U", "V", "W", "theta", "P"] + [f"q{i + 1}" for i in range(num_tracers)]
        else:
            lat2 = geom.to_single_block(geom.lat)
            lon2 = geom.to_single_block(geom.lon)
            block2 = lambda a: a
            grid_dims = ("time", "panel", "Ydim", "Xdim")
            names = ["h", "U", "V", "RV", "PV"]

        lat = f.var("lat", ("panel", "Ydim", "Xdim"))
        lon = f.var("lon", ("panel", "Ydim", "Xdim"))
        lat[:] = np.degrees(block2(lat2))
        lon[:] = np.degrees(block2(lon2))

        self.vars = {name: f.var(name, grid_dims) for name in names}
        self.num_tracers = num_tracers
        self.num_writes = 0

    def write_sw(self, time_s: float, q: np.ndarray):
        from .diagnostics import potential_vorticity, relative_vorticity

        geom, metric, ops = self.geom, self.metric, self.ops
        h = np.asarray(q[0])
        u1 = np.asarray(q[1]) / h
        u2 = np.asarray(q[2]) / h
        u, v = geom.contra2wind(u1, u2)
        rv = relative_vorticity(u1, u2, metric, ops)
        pv = potential_vorticity(h, u1, u2, metric, ops)
        h_out = h + np.asarray(self.topo.hsurf) if self.topo is not None else h

        i = self.num_writes
        self.tvar[i] = time_s
        for name, fld in (("h", h_out), ("U", u), ("V", v), ("RV", rv), ("PV", pv)):
            self.vars[name][i] = geom.to_single_block(np.asarray(fld))
        self.num_writes += 1
        self.file.sync()

    def write_euler(self, time_s: float, q: np.ndarray):
        """3D Euler: rho, the physical winds (U, V, W), theta, pressure (+
        tracer mixing ratios q1..), reference
        output_cubesphere_netcdf.py:331-367."""
        from ..common.constants import CPD, CVD, P0, RD

        geom, metric = self.geom, self.metric
        q = np.asarray(q)
        rho = q[0]
        u1, u2, u3 = q[1] / rho, q[2] / rho, q[3] / rho
        theta = q[4] / rho
        u, v, w = geom.contra2wind_3d(u1, u2, u3, metric)
        pressure = P0 * (q[4] * RD / P0) ** (CPD / CVD)

        s, nel_h, nel_v = geom.num_solpts, geom.nel_h, geom.nel_v
        blk = lambda a: _to_single_block_3d(a, nel_v, nel_h, s)
        i = self.num_writes
        self.tvar[i] = time_s
        fields = [("rho", rho), ("U", u), ("V", v), ("W", w), ("theta", theta), ("P", pressure)]
        fields += [(f"q{k + 1}", q[5 + k] / rho) for k in range(self.num_tracers)]
        for name, fld in fields:
            self.vars[name][i] = blk(np.asarray(fld))
        self.num_writes += 1
        self.file.sync()

    def close(self):
        self.file.close()


def make_writer(path: str, geom, metric, ops, equations: str, topo=None,
                num_tracers: int = 0) -> Optional[NetCDFWriter]:
    """A writer at ``path``, or None without a NetCDF backend."""
    if not HAVE_NETCDF:
        return None
    return NetCDFWriter(path, geom, metric, ops, equations, topo=topo, num_tracers=num_tracers)
