"""Run the 2D Cartesian Euler CUDA source (csrc/euler_cartesian.cu) on the
CPU, without a card and without nvcc: the source is rewritten for the host
shim of the CUDA runtime in tools/sw_host_shim.py (one std::thread per CUDA
thread, a std::barrier for ``__syncthreads``, shared memory filled with
0xff so an unwritten read shows as NaN), compiled with g++ and called
through its C entries with CPU tensors, as the wrappers of
``ops/euler_cartesian_operator.py`` call them on the card.

    python tools/cartesian_host_shim.py [--shapes 4,3,2:3,2,4] [--fv 8,6]

Each (nel_x, nel_z, s) shape runs ``kernels/check.py::
compare_euler_cartesian`` (RHS, stage, stage + x, the tangent at a
perturbed state and at rest; float64 and float32; cases 2 and 4) and each
FV grid ``compare_euler_cartesian_fv`` (every flux: the RHS and the tangent
at a perturbed state and at rest) with the shim's library
in place of the card's, and prints one JSON line each: every mode's scaled
error and ``ok``. The shim says nothing about speed, nor about what nvcc
refuses; its bits are not the card's (g++ does not contract a*b + c into an
fma here).
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
OUT = ROOT / "build" / "host_shim" / "cartesian"


def build():
    """The ctypes library of csrc/euler_cartesian.cu built for the shim."""
    from sw_host_shim import SHIM, translate

    from wxfactory_tpu_torch.kernels import build as kbuild

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cuda_runtime.h").write_text(SHIM)
    src = (ROOT / "wxfactory_tpu_torch" / "csrc" / "euler_cartesian.cu").read_text()
    (OUT / "euler_cartesian.cu").write_text(translate(src))
    so = OUT / "libeuler_cartesian.so"
    cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{OUT}", "-x", "c++",
           str(OUT / "euler_cartesian.cu"), "-o", str(so)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in kbuild.SIGNATURES["euler_cartesian"].items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def install(lib) -> None:
    """Point the four wrappers of ``ops.euler_cartesian_operator`` at the
    shim's C entries for CPU tensors (outputs start as NaN)."""
    import torch

    from wxfactory_tpu_torch.ops import euler_cartesian_operator as ecop

    p = ecop._ptr
    f64 = lambda q: 1 if q.dtype == torch.float64 else 0

    def check(rc, entry):
        if rc != 0:
            raise RuntimeError(f"{entry} returned {rc}")

    def operator(q, con, x=None, a=0.0, b=1.0, cdt=None):
        use_x = cdt is not None and a != 0.0
        out = torch.full_like(q, float("nan"))
        check(lib.euler_cartesian_launch(f64(q), con.s, con.nel_x, con.nel_z, p(q), p(con.ops1d),
                                         p(x if use_x else None), p(out), float(a), float(b),
                                         float(cdt if cdt is not None else 0.0), 1 if cdt is not None else 0, None),
              "euler_cartesian_launch")
        return out

    def tangent(q, v, con):
        out = torch.full_like(q, float("nan"))
        check(lib.euler_cartesian_tangent_launch(f64(q), con.s, con.nel_x, con.nel_z, p(q), p(v), p(con.ops1d),
                                                 p(out), None), "euler_cartesian_tangent_launch")
        return out

    def fv(q, con):
        out = torch.full_like(q, float("nan"))
        check(lib.euler_cartesian_fv_launch(f64(q), ecop.FV_FLUXES.index(con.flux), con.ncell_x, con.ncell_z, p(q),
                                            p(out), float(con.dx), float(con.dz), None), "euler_cartesian_fv_launch")
        return out

    def fv_tangent(q, v, con):
        out = torch.full_like(q, float("nan"))
        check(lib.euler_cartesian_fv_tangent_launch(f64(q), ecop.FV_FLUXES.index(con.flux), con.ncell_x,
                                                    con.ncell_z, p(q), p(v), p(out), float(con.dx), float(con.dz),
                                                    None), "euler_cartesian_fv_tangent_launch")
        return out

    ecop.euler_cartesian, ecop.euler_cartesian_tangent = operator, tangent
    ecop.euler_cartesian_fv, ecop.euler_cartesian_fv_tangent = fv, fv_tangent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", default="4,3,2:3,2,3:3,2,4:2,2,5:2,1,6", help="nel_x,nel_z,s shapes separated by ':'")
    parser.add_argument("--fv", default="8,6:5,3", help="ncell_x,ncell_z FV grids separated by ':'")
    args = parser.parse_args(argv)
    import torch

    from wxfactory_tpu_torch.kernels import check

    torch.set_num_threads(2)
    install(build())
    ok = True
    for shape in args.shapes.split(":"):
        nx, nz, s = (int(v) for v in shape.split(","))
        for case in (2, 4):
            for dtype in (torch.float64, torch.float32):
                rows = check.compare_euler_cartesian(nx, nz, s, dtype, device="cpu", case=case)
                line = {"nel_x": nx, "nel_z": nz, "s": s, "case": case, "dtype": str(dtype)[6:],
                        "ok": all(r["ok"] for r in rows),
                        "modes": {r["mode"]: {"err": r["err"], "ok": r["ok"], "mass": r.get("mass")} for r in rows}}
                print(json.dumps(line), flush=True)
                ok = ok and line["ok"]
    for grid in args.fv.split(":"):
        nx, nz = (int(v) for v in grid.split(","))
        for flux in ("ausm", "rusanov", "upwind"):
            for dtype in (torch.float64, torch.float32):
                rows = check.compare_euler_cartesian_fv(nx, nz, flux, dtype, device="cpu")
                line = {"ncell_x": nx, "ncell_z": nz, "flux": flux, "dtype": str(dtype)[6:],
                        "ok": all(r["ok"] for r in rows),
                        "modes": {r["mode"]: {"err": r["err"], "ok": r["ok"], "mass": r.get("mass")} for r in rows}}
                print(json.dumps(line), flush=True)
                ok = ok and line["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
