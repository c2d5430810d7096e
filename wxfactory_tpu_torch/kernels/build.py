"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so`` at the
root of the checkout (git-ignored); the hash of the source and of the
headers in ``csrc/`` names the library, so an edited source rebuilds. A missing ``nvcc`` or a failed build
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
        "sw_edges_launch": (_I, [_I, _I, _I] + [_P] * 3 + [_P]),  # is_f64, s, nel, q, ops, traces, stream
        # is_f64, npts, traces, src, flip, conv, halo, stream
        "sw_halo_launch": (_I, [_I, _I] + [_P] * 5 + [_P]),
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
        "sw_run_error_string": (ctypes.c_char_p, [_I]),
    },
    "euler3d_operator": {
        "euler3d_operator_launch": (
            _I,
            [_I, _I, _I, _I]  # is_f64, s, nel_h, nel_v
            # q, halo, ops1d, fields, tch, itf_x, itf_y, itf_z, x, bal, q0, halo0, rhs0, out, traces
            + [_P] * 15
            + [_D, _D, _D, _I]  # a, b, cdt, stage
            + [_P],  # stream
        ),
        "euler3d_tangent_launch": (
            _I,
            [_I, _I, _I, _I]  # is_f64, s, nel_h, nel_v
            # q, v, halo_q, halo_v, ops1d, fields, tch, itf_x, itf_y, itf_z, q0, halo0, out
            + [_P] * 13
            + [_P],  # stream
        ),
        "euler3d_operator_error_string": (ctypes.c_char_p, [_I]),
    },
}

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


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(ARCH_FLAGS + NVCC_FLAGS).encode()).hexdigest()[:12]
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
        cmd = [nvcc_path(), *ARCH_FLAGS, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
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
