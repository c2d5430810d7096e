"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout (git-ignored); the hash of the source, of the headers
in ``csrc/`` and of the flags names the library, so an edited source
rebuilds. A library of ``LIBRARY_SOURCES`` is another library's source built
with flags of its own (the 3D terrain kernels: ``euler3d_terrain``). A missing ``nvcc`` or a failed build
raises: no caller falls back to plain code.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
# C signature of each library's functions: name -> (restype, argtypes).
SIGNATURES = {
    "sw_operator": {
        "sw_operator_launch": (
            _I,
            [_I, _I, _I]  # is_f64, s, nel
            # q, halo, ops, fields, gridrot, itf_x, itf_y, x, q0, u0, itf0, halo0, rhs0, out, traces
            + [_P] * 15
            + [_D, _D, _D, _I]  # a, b, cdt, stage
            + [_P],  # stream
        ),
        # the same with no halo (the state mode): is_f64, s, nel, then q, ops, fields,
        # gridrot, itf_x, itf_y, x, q0, u0, itf0, halo0, rhs0, src, flip, conv, out, traces
        "sw_operator_state_launch": (_I, [_I, _I, _I] + [_P] * 17 + [_D, _D, _D, _I] + [_P]),
        # the same over one tile: is_f64, s, nt and the pointers of a tile
        "sw_tile_launch": (_I, [_I, _I, _I] + [_P] * 15 + [_D, _D, _D, _I] + [_P]),
        # J(q).v's linearisation: is_f64, s, nel, then q, ops, itf_x, itf_y, src, flip, conv, coef
        "sw_tangent_prep_launch": (_I, [_I, _I, _I] + [_P] * 8 + [_P]),
        # J(q).v: is_f64, s, nel, then v, coef, ops, fields, gridrot, itf_x, itf_y, src, flip, conv, out
        "sw_tangent_apply_launch": (_I, [_I, _I, _I] + [_P] * 11 + [_P]),
        # with bottom topography: is_f64, s, nel, then q, ops, fields, gridrot, itf_x, itf_y, x, src, flip,
        # conv, hsurf, hsurf_x, hsurf_y, force, out; a, b, cdt, stage; stream
        "sw_operator_state_topo_launch": (_I, [_I, _I, _I] + [_P] * 15 + [_D, _D, _D, _I] + [_P]),
        # the prep's: is_f64, s, nel, then q, ops, itf_x, itf_y, src, flip, conv, hsurf, hsurf_x, hsurf_y, coef
        "sw_tangent_prep_topo_launch": (_I, [_I, _I, _I] + [_P] * 11 + [_P]),
        # the apply's: is_f64, s, nel, then v, coef, ops, fields, gridrot, itf_x, itf_y, src, flip, conv, force, out
        "sw_tangent_apply_topo_launch": (_I, [_I, _I, _I] + [_P] * 12 + [_P]),
        # the perturbation form's state mode with bottom topography: is_f64, s, nel, then q, ops, fields,
        # gridrot, itf_x, itf_y, x, q0, u0, itf0, halo0, rhs0, src, flip, conv, force, out; a, b, cdt, stage;
        # stream
        "sw_operator_state_pert_topo_launch": (_I, [_I, _I, _I] + [_P] * 17 + [_D, _D, _D, _I] + [_P]),
        "sw_operator_topo_resources": (_I, [_I, _I, _P]),  # is_f64, s, int[5] out
        "sw_operator_pert_topo_resources": (_I, [_I, _I, _P]),  # is_f64, s, int[5] out
        "sw_edges_launch": (_I, [_I, _I, _I] + [_P] * 3 + [_P]),  # is_f64, s, nel, q, ops, traces, stream
        # is_f64, npts, traces, src, flip, conv, halo, stream
        "sw_halo_launch": (_I, [_I, _I] + [_P] * 5 + [_P]),
        # is_f64, s, pert, int[5] out (halo plane; the state mode)
        "sw_operator_resources": (_I, [_I, _I, _I, _P]),
        "sw_operator_state_resources": (_I, [_I, _I, _I, _P]),
        # is_f64, s, kernel (0 prep, 1 apply; 2, 3 theirs with topography), int[5] out
        "sw_tangent_resources": (_I, [_I, _I, _I, _P]),
        "sw_operator_error_string": (ctypes.c_char_p, [_I]),
    },
    "sw_run": {
        "sw_run_launch": (
            _I,
            [_I, _I, _I]  # is_f64, s, nel
            # q, ops, fields, gridrot, itf_x, itf_y, q0, u0, itf0, halo0, rhs0, src, flip, conv,
            # out, buf1, buf2, tr0, tr1, abc (9 host doubles)
            + [_P] * 20
            + [_I, _P],  # nsteps, stream
        ),
        "sw_run_resources": (_I, [_I, _I, _P]),  # is_f64, pert, int[5] out
        "sw_run_error_string": (ctypes.c_char_p, [_I]),
    },
    "euler3d_operator": {
        "euler3d_operator_launch": (
            _I,
            [_I, _I, _I, _I]  # is_f64, s, nel_h, nel_v
            # q, halo, ops1d, fields, tch, itf_x, itf_y, itf_z, x, bal, q0, halo0, rhs0, traces0, out, traces
            + [_P] * 16
            + [_D, _D, _D, _I]  # a, b, cdt, stage
            + [_P],  # stream
        ),
        # the same over one tile: is_f64, s, nt, nel_v and the pointers of a tile
        "euler3d_tile_launch": (_I, [_I, _I, _I, _I] + [_P] * 16 + [_D, _D, _D, _I] + [_P]),
        "euler3d_tangent_prep_launch": (
            _I,
            [_I, _I, _I, _I]  # is_f64, s, nel_h, nel_v
            # q, halo_q, ops1d, fields, itf_x, itf_y, itf_z, q0, halo0, coef
            + [_P] * 10
            + [_P],  # stream
        ),
        "euler3d_tangent_apply_launch": (
            _I,
            [_I, _I, _I, _I]  # is_f64, s, nel_h, nel_v
            # v, halo_v, ops1d, fields, tch, itf_x, itf_y, itf_z, coef, out
            + [_P] * 10
            + [_P],  # stream
        ),
        # is_f64, s, pert, kernel (0 interface pass, 1 volume pass), int[5] out
        "euler3d_operator_resources": (_I, [_I, _I, _I, _I, _P]),
        # is_f64, s, kernel (0 prep, 1 perturbation prep, 2 apply), int[5] out
        "euler3d_tangent_resources": (_I, [_I, _I, _I, _P]),
        "euler3d_operator_error_string": (ctypes.c_char_p, [_I]),
    },
    # The 3D kernels on a per-panel metric (terrain): euler3d_operator.cu
    # built with -DE3_TERRAIN_LIBRARY (LIBRARY_SOURCES).
    "euler3d_terrain": {
        # euler3d_operator_launch's arguments, then the sponge (or NULL), then the stream
        "euler3d_operator_terrain_launch": (_I, [_I, _I, _I, _I] + [_P] * 16 + [_D, _D, _D, _I] + [_P, _P]),
        # euler3d_tangent_prep_launch's arguments
        "euler3d_tangent_prep_terrain_launch": (_I, [_I, _I, _I, _I] + [_P] * 10 + [_P]),
        # euler3d_tangent_apply_launch's arguments, then the sponge (or NULL), then the stream
        "euler3d_tangent_apply_terrain_launch": (_I, [_I, _I, _I, _I] + [_P] * 11 + [_P]),
        # is_f64, s, kernel (0 interface, 1 volume, 2 and 3 theirs in perturbation mode, 4 prep,
        # 5 perturbation prep, 6 apply), int[5] out
        "euler3d_terrain_resources": (_I, [_I, _I, _I, _P]),
        "euler3d_operator_error_string": (ctypes.c_char_p, [_I]),
    },
    # The tracer advection of DCMIP 11/12 (5 + nt rows), a source and library of its own.
    "euler3d_advection": {
        "euler3d_advection_launch": (
            _I,
            [_I, _I, _I, _I, _I]  # is_f64, s, nt, nel_h, nel_v
            # q, halo, ops1d, fields, itf_x, itf_y, itf_z, x, out, traces
            + [_P] * 10
            + [_D, _D, _D, _I]  # a, b, cdt, stage
            + [_P],  # stream
        ),
        # is_f64, s, nt, kernel (0 interface pass, 1 volume pass), int[5] out
        "euler3d_advection_resources": (_I, [_I, _I, _I, _I, _P]),
        "euler3d_advection_error_string": (ctypes.c_char_p, [_I]),
    },
    # The Jacobian action of the tracer advection (a prep and an apply), a source and library of its own.
    "euler3d_advection_tangent": {
        # is_f64, s, nt, nel_h, nel_v, then q, halo_q, ops1d, coef; stream
        "euler3d_advection_tangent_prep_launch": (_I, [_I] * 5 + [_P] * 4 + [_P]),
        # is_f64, s, nt, nel_h, nel_v, then v, halo_v, ops1d, fields, itf_x, itf_y, itf_z, coef, rows, out; stream
        "euler3d_advection_tangent_apply_launch": (_I, [_I] * 5 + [_P] * 10 + [_P]),
        # is_f64, s, nt, kernel (0 prep node pass, 1 prep interface pass, 2 apply interface pass,
        # 3 apply volume pass), int[5] out
        "euler3d_advection_tangent_resources": (_I, [_I, _I, _I, _I, _P]),
        "euler3d_advection_tangent_error_string": (ctypes.c_char_p, [_I]),
    },
    # The 2D Cartesian Euler operators (DFR and finite volume) and their Jacobian actions.
    "euler_cartesian": {
        # is_f64, s, nel_x, nel_z, then q, ops1d, x, out; a, b, cdt, stage; stream
        "euler_cartesian_launch": (_I, [_I, _I, _I, _I] + [_P] * 4 + [_D, _D, _D, _I] + [_P]),
        # is_f64, s, nel_x, nel_z, then q, v, ops1d, out; stream
        "euler_cartesian_tangent_launch": (_I, [_I, _I, _I, _I] + [_P] * 4 + [_P]),
        # is_f64, flux (0 ausm, 1 rusanov, 2 upwind), ncell_x, ncell_z, then q, out; dx, dz; stream
        "euler_cartesian_fv_launch": (_I, [_I, _I, _I, _I] + [_P] * 2 + [_D, _D] + [_P]),
        # is_f64, flux, ncell_x, ncell_z, then q, v, out; dx, dz; stream
        "euler_cartesian_fv_tangent_launch": (_I, [_I, _I, _I, _I] + [_P] * 3 + [_D, _D] + [_P]),
        # is_f64, s (the flux for kernels 2 and 3), kernel (0 operator, 1 tangent, 2 FV, 3 FV tangent), int[5] out
        "euler_cartesian_resources": (_I, [_I, _I, _I, _P]),
        "euler_cartesian_error_string": (ctypes.c_char_p, [_I]),
    },
}

# A library built from another library's source with extra nvcc flags: name
# -> (source name in csrc/, flags).
LIBRARY_SOURCES = {"euler3d_terrain": ("euler3d_operator", ["-DE3_TERRAIN_LIBRARY"])}

_loaded = {}
# name -> {"seconds": build time, "log": nvcc output} of builds made by this process
build_info = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): cannot build the CUDA kernels")


def _source(name: str):
    """(source file, extra nvcc flags) of library ``name``."""
    base, flags = LIBRARY_SOURCES.get(name, (name, []))
    return CSRC / f"{base}.cu", flags


def library_path(name: str) -> Path:
    src, flags = _source(name)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    options = " ".join(ARCH_FLAGS + NVCC_FLAGS + flags).encode()
    digest = hashlib.sha256(src.read_bytes() + headers + options).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names) -> dict:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together; returns {name: library path}."""
    libs = {name: library_path(name) for name in names}
    running = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        src, flags = _source(name)
        cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, *flags, "-o", tmp, str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, time.perf_counter())
    failures = []
    for name, (proc, tmp, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed ({proc.returncode}) building {name}:\n{log}")
            continue
        os.replace(tmp, libs[name])  # atomic: a concurrent build never sees a partial file
        build_info[name] = {"seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return libs


def load_library(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    if name not in _loaded:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _loaded[name] = lib
    return _loaded[name]
