"""Run the tracer-advection CUDA sources (csrc/euler3d_advection.cu and
csrc/euler3d_advection_tangent.cu) on the CPU, without a card and without
nvcc: each source is rewritten for the host shim of the CUDA runtime in
tools/sw_host_shim.py (one std::thread per CUDA thread, a std::barrier for
``__syncthreads``; stream-ordered pool allocations as malloc filled with
0xff, so an unwritten flux row reads as NaN), compiled with g++ and called
through its C entries with CPU tensors, as ``ops/euler3d_operator.py``'s
wrappers call them on the card.

    python tools/advection_host_shim.py [--shapes 2,1,2:3,2,3] [--tracers 1,4]

Each (nel_h, nel_v, s) shape and tracer count runs
``kernels/check.py::compare_euler3d_advection`` with the shim's RHS library
in place of the card's (every mode, float64 and float32, its tolerances and
mass checks) and ``compare_euler3d_advection_tangent`` with the shim's
prep and apply (and RHS) libraries, and prints one JSON line each: each
mode's scaled error, its ``ok``, and each tracer's mass. The shim says
nothing about speed, nor about what nvcc refuses; its bits are not the
card's (g++ does not contract a*b + c into an fma here).
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
OUT = ROOT / "build" / "host_shim" / "advection"

POOL = r"""
#define __align__(n)
typedef void* cudaMemPool_t;
enum { cudaMemAllocationTypePinned = 1, cudaMemLocationTypeDevice = 1 };
enum cudaMemPoolAttr { cudaMemPoolAttrReleaseThreshold = 4 };
struct cudaMemLocation { int type = 0; int id = 0; };
struct cudaMemPoolProps { int allocType = 0; cudaMemLocation location; };
inline cudaError_t cudaMemPoolCreate(cudaMemPool_t* p, const cudaMemPoolProps*) { *p = (void*)1; return cudaSuccess; }
inline cudaError_t cudaMemPoolSetAttribute(cudaMemPool_t, cudaMemPoolAttr, void*) { return cudaSuccess; }
inline cudaError_t cudaMallocFromPoolAsync(void** p, size_t n, cudaMemPool_t, cudaStream_t) {
  *p = std::malloc(n);
  std::memset(*p, 0xff, n);  // unwritten rows read as NaN
  return cudaSuccess;
}
inline cudaError_t cudaFreeAsync(void* p, cudaStream_t) { std::free(p); return cudaSuccess; }
"""


def build(name: str = "euler3d_advection"):
    """The ctypes library of csrc/<name>.cu built for the shim."""
    from sw_host_shim import SHIM, translate

    from wxfactory_tpu_torch.kernels import build as kbuild

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "cuda_runtime.h").write_text(SHIM + POOL)
    header = "euler3d_advection_common.cuh"
    (OUT / header).write_text(translate((ROOT / "wxfactory_tpu_torch" / "csrc" / header).read_text()))
    src = (ROOT / "wxfactory_tpu_torch" / "csrc" / f"{name}.cu").read_text()
    (OUT / f"{name}.cu").write_text(translate(src.replace("__align__(16) ", "")))
    so = OUT / f"lib{name}.so"
    cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{OUT}", "-x", "c++",
           str(OUT / f"{name}.cu"), "-o", str(so)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{proc.stdout}")
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in kbuild.SIGNATURES[name].items():
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    return lib


def shim_advection(lib):
    """``ops.euler3d_operator.euler3d_advection`` with the shim's library for
    CPU tensors: the wrapper's checks, then the C entry as
    ``_launch_advection`` calls it (outputs start as NaN)."""
    import torch

    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    def call(q, halo, con, x=None, a=0.0, b=1.0, cdt=None, emit_traces=False):
        nt = q.shape[0] - 5
        use_x = cdt is not None and a != 0.0
        out = torch.full_like(q, float("nan"))
        traces = (torch.full(e3op._advection_shapes(q, con)[1], float("nan"), dtype=q.dtype)
                  if emit_traces else None)
        p = e3op._ptr
        rc = lib.euler3d_advection_launch(
            1 if q.dtype == torch.float64 else 0, con.s, nt, con.nel_h, con.nel_v, p(q), p(halo), p(con.ops1d),
            p(con.fields), p(con.itf_x), p(con.itf_y), p(con.itf_z), p(x if use_x else None), p(out), p(traces),
            float(a), float(b), float(cdt if cdt is not None else 0.0), 1 if cdt is not None else 0, None)
        if rc != 0:
            raise RuntimeError(f"euler3d_advection_launch returned {rc}")
        return (out, traces) if emit_traces else out

    return call


def shim_tangent(lib):
    """``ops.euler3d_operator.euler3d_advection_tangent_prep`` and ``_apply``
    with the shim's library for CPU tensors: the C entries as
    ``_launch_advection_tangent`` calls them (outputs start as NaN)."""
    import torch

    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    p = e3op._ptr
    head = lambda con, nt: (1 if con.dtype == torch.float64 else 0, con.s, nt, con.nel_h, con.nel_v)

    def prep(q, halo, con):
        nt = q.shape[0] - 5
        values = torch.full((e3op.advection_tangent_layout(con, nt)["size"],), float("nan"), dtype=q.dtype)
        rc = lib.euler3d_advection_tangent_prep_launch(*head(con, nt), p(q), p(halo), p(con.ops1d), p(values), None)
        if rc != 0:
            raise RuntimeError(f"euler3d_advection_tangent_prep_launch returned {rc}")
        return e3op.AdvectionTangentCoefficients(values, nt)

    def apply(v, halo, coef, con):
        rows = torch.full((coef.ntracer * e3op.advection_interface_points(con),), float("nan"), dtype=v.dtype)
        out = torch.full_like(v, float("nan"))
        rc = lib.euler3d_advection_tangent_apply_launch(
            *head(con, coef.ntracer), p(v), p(halo), p(con.ops1d), p(con.fields), p(con.itf_x), p(con.itf_y),
            p(con.itf_z), p(coef.values), p(rows), p(out), None)
        if rc != 0:
            raise RuntimeError(f"euler3d_advection_tangent_apply_launch returned {rc}")
        return out

    return prep, apply


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", default="2,1,2:3,2,3:2,1,4", help="nel_h,nel_v,s shapes separated by ':'")
    parser.add_argument("--tracers", default="1,4", help="tracer counts (1: DCMIP 12, 4: DCMIP 11)")
    args = parser.parse_args(argv)
    import torch

    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    torch.set_num_threads(2)
    e3op.euler3d_advection = shim_advection(build())
    e3op.euler3d_advection_tangent_prep, e3op.euler3d_advection_tangent_apply = shim_tangent(
        build("euler3d_advection_tangent"))
    ok = True
    for shape in args.shapes.split(":"):
        nel_h, nel_v, s = (int(v) for v in shape.split(","))
        for nt in (int(v) for v in args.tracers.split(",")):
            for dtype in (torch.float64, torch.float32):
                rows = check.compare_euler3d_advection(nel_h, nel_v, s, nt, dtype, device="cpu")
                line = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "ntracer": nt, "dtype": str(dtype)[6:],
                        "ok": all(r["ok"] for r in rows),
                        "modes": {r["mode"]: {"err": r["err"], "traces_err": r.get("traces_err"), "ok": r["ok"],
                                              "mass": [(m["err"], m["own"]) for m in r["tracer_mass"]]}
                                  for r in rows}}
                print(json.dumps(line), flush=True)
                ok = ok and line["ok"]
                rows = check.compare_euler3d_advection_tangent(nel_h, nel_v, s, nt, dtype, device="cpu")
                line = {"nel_h": nel_h, "nel_v": nel_v, "s": s, "ntracer": nt, "dtype": str(dtype)[6:],
                        "kernel": "tangent", "ok": all(r["ok"] for r in rows),
                        "modes": {r["mode"]: {k: r.get(k) for k in ("err", "prep_err", "apply_err", "tie_flips",
                                                                      "rhs_linearity_err", "ok")}
                                  | {"mass": [(m["err"], m["own_dT"]) for m in r["tracer_mass"]]} for r in rows}}
                print(json.dumps(line), flush=True)
                ok = ok and line["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
