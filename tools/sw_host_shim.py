"""Run the shallow-water CUDA sources (csrc/sw_operator.cu, csrc/sw_run.cu
and the header they share) on the CPU, without a card and without nvcc:
each source is rewritten for a small host shim of the CUDA runtime (one
std::thread per CUDA thread, a std::barrier for ``__syncthreads`` and for
the cooperative grid's ``sync``), compiled with g++ and called through the
same C entries, with CPU tensors, as the wrappers call them on the card.

    python tools/sw_host_shim.py [--source DIR] [--parent DIR] [--sms N] [--shapes 4,3:3,4]

``--source`` (default: the package's csrc/) and ``--parent`` (another
version of the three files, e.g. written by ``git show REV:path`` into a
git-ignored directory, or a path prefix such as ``build/parent_``) are each
built into build/host_shim/; the script
then calls both libraries on the same inputs (Williamson case 6 with
seeded noise; the perturbation form around it) in every mode of the
operator (RHS, stage with and without x, traces; absolute and
perturbation; float64 and float32), the tile launch, the edge kernel and
the whole-run kernel, and prints one JSON line a shape: whether the two
agree bit for bit (``torch.equal``), and each one's largest scaled
distance from the plain torch version. Without ``--parent`` only the
latter. The whole-sphere operator's state mode (no halo: the panel-edge
faces read the neighbour panels' state, ``sw_operator_state_launch``) is
called in RHS and stage modes, absolute and perturbation; a library
without it (a parent from before it) takes the route it replaces in its
place, the edge and halo kernels then the operator fed their halo. The
line's ``state_equals_route`` says whether each library's state mode
equals its own three-launch route bit for bit. The Jacobian action J(q).v
(the prep kernel ``sw_tangent_prep_launch`` then the apply kernel
``sw_tangent_apply_launch``; in a parent from before that split, the
one-call ``sw_tangent_state_launch``) is held against ``sw_tangent_plain``
at the case-6 and rest points of ``kernels/check.py::sw_tangent_inputs``
(``tangent_plain_err``, and the mass of J.v against the plain one's,
``tangent_mass_err``); the prep and the apply each against their plain
versions on the same buffer (``tangent_split_err``); and the two
libraries' J.v against each other (``tangent_between``, scaled, and
``tangent_identical``, bit for bit where both have the same design).
``A source with bottom topography (``sw_operator_state_topo_launch`` and the
tangent pair's ``*_topo_launch``) is also held, on Williamson case 5,
against the plain versions with topography, and bit for bit with null
planes against its entries without topography and with all-zero planes
against null ones (``check_topo_shape``); with ``--parent`` its topography
entries bit for bit against the parent's (``topo_identical``); a source
with the perturbation form's entry with topography
(``sw_operator_state_pert_topo_launch``) also against its plain version
around case 5's base with topography, and with all-zero forcing planes on
a base without topography bit for bit against the perturbation entry
without (``pert_topo_bits``). A shape with s = 1 checks only
the tangent pair there (the fv-mg levels).
``--sms`` is the SM count
the shim reports (it sets the tile launch's elements a block).
A design can so be checked against its
parent before its first chip call; the shim says nothing about speed, and
nothing about what nvcc refuses.

The host compiler does not contract a*b + c into an fma (``-ffp-contract=off``)
where nvcc does, so the shim's bits are not the card's: compare two
sources built here, never a shim result with a card result.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "build" / "host_shim"
FILES = ("sw_element.cuh", "sw_operator.cu", "sw_run.cu")

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorInvalidDevice = 101,
       cudaErrorCooperativeLaunchTooLarge = 720 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
struct cudaFuncAttributes { int numRegs = 0; size_t localSizeBytes = 0; };

inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
namespace shim {
inline thread_local std::barrier<>* block_barrier = nullptr;
inline thread_local std::barrier<>* grid_barrier = nullptr;
inline thread_local unsigned char* dyn = nullptr;
inline thread_local unsigned char* stat = nullptr;
inline unsigned char* dyn_smem() { return dyn; }
inline unsigned char* static_smem() { return stat; }
inline int sms() { const char* e = std::getenv("SHIM_SMS"); return e ? std::atoi(e) : 132; }

// Runs the blocks [b0, b1) of a launch at once, one std::thread per CUDA
// thread; `grid` (cooperative launches) spans every thread of the grid.
inline void run_blocks(dim3 g, dim3 b, size_t smem, unsigned b0, unsigned b1, std::barrier<>* grid,
                       const std::function<void()>& body) {
  const unsigned nt = b.x * b.y * b.z;
  std::vector<std::unique_ptr<std::barrier<>>> bars;
  std::vector<std::vector<unsigned char>> dyns, stats;
  for (unsigned k = b0; k < b1; ++k) {
    bars.emplace_back(new std::barrier<>(nt));
    dyns.emplace_back(smem + 16, 0xff);  // unwritten shared memory reads as NaN
    stats.emplace_back(1 << 16, 0xff);
  }
  std::vector<std::thread> threads;
  for (unsigned k = b0; k < b1; ++k)
    for (unsigned t = 0; t < nt; ++t)
      threads.emplace_back([&, k, t] {
        threadIdx = dim3(t % b.x, (t / b.x) % b.y, t / (b.x * b.y));
        blockIdx = dim3(k);
        blockDim = b;
        gridDim = g;
        block_barrier = bars[k - b0].get();
        grid_barrier = grid;
        dyn = dyns[k - b0].data();
        stat = stats[k - b0].data();
        body();
      });
  for (auto& th : threads) th.join();
}
inline void launch(dim3 g, dim3 b, size_t smem, const std::function<void()>& body) {
  for (unsigned k = 0; k < g.x; ++k) run_blocks(g, b, smem, k, k + 1, nullptr, body);
}
template <typename K, typename A>
inline cudaError_t coop_launch(K kernel, dim3 g, dim3 b, size_t smem, A& args) {
  std::barrier<> grid(g.x * b.x * b.y * b.z);
  run_blocks(g, b, smem, 0, g.x, &grid, [&] { kernel(args); });
  return cudaSuccess;
}
}  // namespace shim

inline void __syncthreads() { shim::block_barrier->arrive_and_wait(); }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline float __fsqrt_rn(float v) { return std::sqrt(v); }
inline double __dsqrt_rn(double v) { return std::sqrt(v); }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "shim error"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = shim::sms(); return cudaSuccess; }
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
template <typename K>
inline cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, K) { *a = cudaFuncAttributes{}; return cudaSuccess; }
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) { *n = 1; return cudaSuccess; }
"""

COOPERATIVE = r"""
#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct grid_group {
  void sync() { shim::grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return grid_group{}; }
}  // namespace cooperative_groups
"""


def _split_top(text: str):
    """Split at the commas outside parentheses and angle brackets."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        if ch in "(<[":
            depth += 1
        elif ch in ")>]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    parts.append(cur.strip())
    return parts


def translate(src: str) -> str:
    """A CUDA source rewritten for the shim."""
    def launch(m):
        grid, block, smem, _stream = _split_top(m.group(2))
        return f"shim::launch(dim3({grid}), dim3({block}), {smem}, [&]() {{ {m.group(1)}({m.group(3)}); }});"

    src = re.sub(r"([\w:]+(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", launch, src, flags=re.S)
    src = re.sub(r"cudaLaunchCooperativeKernel\(reinterpret_cast<void\*>\((\w+)\),\s*(dim3\(.*?\)),\s*(dim3\(.*?\)),"
                 r"\s*args,\s*smem,\s*stream\)", r"shim::coop_launch(\1, \2, \3, smem, R)", src, flags=re.S)
    src = src.replace("extern __shared__ unsigned char smem_raw[];", "unsigned char* smem_raw = shim::dyn_smem();")
    src = re.sub(r"__shared__ (\w+) (\w+)\[[^\]]*\];", r"\1* \2 = reinterpret_cast<\1*>(shim::static_smem());", src)
    if "<<<" in src or "__shared__" in src or "cudaLaunchCooperativeKernel" in src:
        raise ValueError("a launch or shared declaration the shim does not translate is left")
    return src


def build(source: Path, tag: str) -> dict:
    """{name: ctypes library} of the source set in ``source`` built for the shim."""
    from wxfactory_tpu_torch.kernels import build as kbuild

    work = OUT / tag
    work.mkdir(parents=True, exist_ok=True)
    (work / "cuda_runtime.h").write_text(SHIM)
    (work / "cooperative_groups.h").write_text(COOPERATIVE)
    for name in FILES:
        path = (source / name) if source.is_dir() else Path(str(source) + name)
        (work / name).write_text(translate(path.read_text()))
    procs = {}
    for name in ("sw_operator", "sw_run"):
        so = work / f"lib{name}.so"
        cmd = ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-fPIC", "-shared", "-pthread", f"-I{work}",
               "-x", "c++", str(work / f"{name}.cu"), "-o", str(so)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {tag}/{name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in kbuild.SIGNATURES[name].items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        libs[name] = lib
    return libs


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _stream(q):
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream) if q.device.type == "cuda" else None


def _alloc(shape, q, nan_fill: bool):
    import torch

    make = torch.full if nan_fill else (lambda size, _, **kw: torch.empty(size, **kw))
    return make(tuple(shape), float("nan"), dtype=q.dtype, device=q.device)


def operator_call(lib, entry, q, halo, con, x=None, a=0.0, b=1.0, cdt=None, emit_traces=False, base=None,
                  nan_fill=True):
    """One call of the operator's C entry ``entry`` of ``lib`` (built here
    for the shim, or by nvcc for the card) on tensors of the library's
    device; the wrapper's arguments and results
    (``ops/sw_operator.py::_launch_operator``). ``nan_fill``: outputs
    start as NaN (an unwritten entry shows), else uninitialised (timing)."""
    import torch

    out = _alloc(q.shape, q, nan_fill)
    traces = _alloc((3, 4, con.npanel, con.nel, con.s), q, nan_fill) if emit_traces else None
    pb = base.tensors if base is not None else {}
    use_x = cdt is not None and a != 0.0
    rc = getattr(lib, entry)(
        1 if q.dtype == torch.float64 else 0, con.s, con.nel, _ptr(q), _ptr(halo), _ptr(con.ops), _ptr(con.fields),
        _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y), _ptr(x if use_x else None), _ptr(pb.get("q0")),
        _ptr(pb.get("u0")), _ptr(pb.get("itf0")), _ptr(pb.get("halo0")), _ptr(pb.get("rhs0")), _ptr(out),
        _ptr(traces), float(a), float(b), float(cdt if cdt is not None else 0.0), 1 if cdt is not None else 0,
        _stream(q))
    if rc != 0:
        raise RuntimeError(f"{entry} returned {rc}")
    return (out, traces) if emit_traces else out


def state_call(lib, q, con, topology, x=None, a=0.0, b=1.0, cdt=None, emit_traces=False, base=None,
               nan_fill=True):
    """One call of the state mode (``sw_operator_state_launch``): the
    wrapper's ``sw_operator(q, None, ...)``."""
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, q.device, q.dtype)
    out = _alloc(q.shape, q, nan_fill)
    traces = _alloc((3, 4, 6, con.nel, con.s), q, nan_fill) if emit_traces else None
    pb = base.tensors if base is not None else {}
    use_x = cdt is not None and a != 0.0
    rc = lib.sw_operator_state_launch(
        1 if q.dtype == torch.float64 else 0, con.s, con.nel, _ptr(q), _ptr(con.ops), _ptr(con.fields),
        _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y), _ptr(x if use_x else None), _ptr(pb.get("q0")),
        _ptr(pb.get("u0")), _ptr(pb.get("itf0")), _ptr(pb.get("halo0")), _ptr(pb.get("rhs0")), _ptr(tab.src),
        _ptr(tab.flip), _ptr(tab.conv), _ptr(out), _ptr(traces), float(a), float(b),
        float(cdt if cdt is not None else 0.0), 1 if cdt is not None else 0, _stream(q))
    if rc != 0:
        raise RuntimeError(f"sw_operator_state_launch returned {rc}")
    return (out, traces) if emit_traces else out


def has_tangent_pair(lib) -> bool:
    return hasattr(lib, "sw_tangent_prep_launch")


def tangent_prep_call(lib, q, con, topology, nan_fill=True):
    """One call of the tangent prep kernel (``sw_tangent_prep_launch``): the
    wrapper's ``sw_tangent_prep(q, ...)``, the coefficient buffer."""
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, q.device, q.dtype)
    coef = _alloc((swop.sw_tangent_layout(con)["size"],), q, nan_fill)
    rc = lib.sw_tangent_prep_launch(
        1 if q.dtype == torch.float64 else 0, con.s, con.nel, _ptr(q), _ptr(con.ops), _ptr(con.itf_x),
        _ptr(con.itf_y), _ptr(tab.src), _ptr(tab.flip), _ptr(tab.conv), _ptr(coef), _stream(q))
    if rc != 0:
        raise RuntimeError(f"sw_tangent_prep_launch returned {rc}")
    return coef


def tangent_apply_call(lib, coef, v, con, topology, nan_fill=True):
    """One call of the tangent apply kernel (``sw_tangent_apply_launch``):
    the wrapper's ``sw_tangent_apply(coef, v, ...)``."""
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, v.device, v.dtype)
    out = _alloc(v.shape, v, nan_fill)
    rc = lib.sw_tangent_apply_launch(
        1 if v.dtype == torch.float64 else 0, con.s, con.nel, _ptr(v), _ptr(coef), _ptr(con.ops), _ptr(con.fields),
        _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y), _ptr(tab.src), _ptr(tab.flip), _ptr(tab.conv),
        _ptr(out), _stream(v))
    if rc != 0:
        raise RuntimeError(f"sw_tangent_apply_launch returned {rc}")
    return out


def tangent_state_call(lib, q, v, con, topology, nan_fill=True):
    """One call of a parent's one-call tangent kernel
    (``sw_tangent_state_launch``, the sources before the prep + apply
    split)."""
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, q.device, q.dtype)
    out = _alloc(q.shape, q, nan_fill)
    rc = lib.sw_tangent_state_launch(
        1 if q.dtype == torch.float64 else 0, con.s, con.nel, _ptr(q), _ptr(v), _ptr(con.ops), _ptr(con.fields),
        _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y), _ptr(tab.src), _ptr(tab.flip), _ptr(tab.conv),
        _ptr(out), _stream(q))
    if rc != 0:
        raise RuntimeError(f"sw_tangent_state_launch returned {rc}")
    return out


def has_topo(lib) -> bool:
    return hasattr(lib, "sw_operator_state_topo_launch")


def topo_state_call(lib, q, con, topology, topo, x=None, a=0.0, b=1.0, cdt=None, nan_fill=True):
    """One call of the state mode with bottom topography
    (``sw_operator_state_topo_launch``; ``topo=None`` its null planes): the
    wrapper's ``sw_operator(q, None, ..., topo=topo)``."""
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, q.device, q.dtype)
    out = _alloc(q.shape, q, nan_fill)
    use_x = cdt is not None and a != 0.0
    planes = (topo.hsurf, topo.hsurf_x, topo.hsurf_y, topo.force) if topo is not None else (None,) * 4
    rc = lib.sw_operator_state_topo_launch(
        1 if q.dtype == torch.float64 else 0, con.s, con.nel, _ptr(q), _ptr(con.ops), _ptr(con.fields),
        _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y), _ptr(x if use_x else None), _ptr(tab.src),
        _ptr(tab.flip), _ptr(tab.conv), *[_ptr(t) for t in planes], _ptr(out), float(a), float(b),
        float(cdt if cdt is not None else 0.0), 1 if cdt is not None else 0, _stream(q))
    if rc != 0:
        raise RuntimeError(f"sw_operator_state_topo_launch returned {rc}")
    return out


def has_pert_topo(lib) -> bool:
    return hasattr(lib, "sw_operator_state_pert_topo_launch")


def pert_topo_state_call(lib, dq, con, topology, base, force, x=None, a=0.0, b=1.0, cdt=None, nan_fill=True):
    """One call of the perturbation form's state mode with bottom topography
    (``sw_operator_state_pert_topo_launch``): the wrapper's
    ``sw_operator(dq, None, ..., base=base, topo=topo)`` with ``force`` =
    ``topo.force``."""
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, dq.device, dq.dtype)
    out = _alloc(dq.shape, dq, nan_fill)
    pb = base.tensors
    use_x = cdt is not None and a != 0.0
    rc = lib.sw_operator_state_pert_topo_launch(
        1 if dq.dtype == torch.float64 else 0, con.s, con.nel, _ptr(dq), _ptr(con.ops), _ptr(con.fields),
        _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y), _ptr(x if use_x else None), _ptr(pb["q0"]),
        _ptr(pb["u0"]), _ptr(pb["itf0"]), _ptr(pb["halo0"]), _ptr(pb["rhs0"]), _ptr(tab.src), _ptr(tab.flip),
        _ptr(tab.conv), _ptr(force), _ptr(out), float(a), float(b), float(cdt if cdt is not None else 0.0),
        1 if cdt is not None else 0, _stream(dq))
    if rc != 0:
        raise RuntimeError(f"sw_operator_state_pert_topo_launch returned {rc}")
    return out


def topo_tangent_call(lib, q, v, con, topology, topo, nan_fill=True):
    """(coef, J.v) of the tangent pair with bottom topography
    (``sw_tangent_prep_topo_launch``, ``sw_tangent_apply_topo_launch``)."""
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, q.device, q.dtype)
    f64 = 1 if q.dtype == torch.float64 else 0
    coef = _alloc((swop.sw_tangent_layout(con)["size"],), q, nan_fill)
    rc = lib.sw_tangent_prep_topo_launch(
        f64, con.s, con.nel, _ptr(q), _ptr(con.ops), _ptr(con.itf_x), _ptr(con.itf_y), _ptr(tab.src),
        _ptr(tab.flip), _ptr(tab.conv), _ptr(topo.hsurf), _ptr(topo.hsurf_x), _ptr(topo.hsurf_y), _ptr(coef),
        _stream(q))
    if rc != 0:
        raise RuntimeError(f"sw_tangent_prep_topo_launch returned {rc}")
    out = _alloc(v.shape, v, nan_fill)
    rc = lib.sw_tangent_apply_topo_launch(
        f64, con.s, con.nel, _ptr(v), _ptr(coef), _ptr(con.ops), _ptr(con.fields), _ptr(con.gridrot),
        _ptr(con.itf_x), _ptr(con.itf_y), _ptr(tab.src), _ptr(tab.flip), _ptr(tab.conv), _ptr(topo.force),
        _ptr(out), _stream(v))
    if rc != 0:
        raise RuntimeError(f"sw_tangent_apply_topo_launch returned {rc}")
    return coef, out


def check_topo_shape(lib, nel: int, s: int, parent=None) -> dict:
    """A library with topography entries at (nel, s) on Williamson case 5
    (``kernels/check.py::sw_topo_inputs``): the state mode with topography
    (RHS, stage, stage with x) and the tangent pair with topography against
    their plain versions (scaled by each variable's max); and bit for bit
    (``torch.equal``) the topography entry with null planes against the
    entry without, and with all-zero planes against null ones. At s = 1
    only the tangent pair (the fv-mg levels' case-6 state). With a
    ``parent`` library that has the topography entries, theirs bit for bit
    against the parent's (``topo_identical``); with the perturbation
    form's entry with topography, that entry against its plain version
    (keys "pert ...") and, with zero forcing planes on a base without
    topography, bit for bit against the perturbation entry without
    (``pert_topo_bits``)."""
    import torch

    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    out = {"nel": nel, "s": s, "topo_plain_err": {}, "topo_bits": True, "tangent_s1_err": {}}
    both = parent is not None and has_topo(parent)
    if both:
        out["topo_identical"] = True
    if has_pert_topo(lib) and s >= 2:
        out["pert_topo_bits"] = True
    for dtype in (torch.float64, torch.float32):
        dname = "f64" if dtype == torch.float64 else "f32"
        if s == 1:
            con, topology, states, v, _ = check.sw_tangent_inputs(nel, s, dtype, "cpu")
            for point, q in states.items():
                jv = tangent_apply_call(lib, tangent_prep_call(lib, q, con, topology), v, con, topology)
                want = swop.sw_tangent_plain(q, v, con, topology)
                out["tangent_s1_err"][f"{dname} {point}"] = _scaled_err(jv, want)
            continue
        con, topology, topo, x, y, zero = check.sw_topo_inputs(nel, s, dtype, "cpu")
        for mode, kw in {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=check.DT),
                         "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * check.DT)}.items():
            got = topo_state_call(lib, y, con, topology, topo, **kw)
            want = swop.sw_operator_plain(y, None, con, topology=topology, topo=topo, **kw)
            out["topo_plain_err"][f"{dname} {mode}"] = _scaled_err(got, want)
            null = topo_state_call(lib, y, con, topology, None, **kw)
            zeros = topo_state_call(lib, y, con, topology, zero, **kw)
            plain_entry = state_call(lib, y, con, topology, **kw)
            out["topo_bits"] = out["topo_bits"] and torch.equal(null, plain_entry) and torch.equal(zeros, null)
            if both:
                out["topo_identical"] = out["topo_identical"] and torch.equal(
                    got, topo_state_call(parent, y, con, topology, topo, **kw))
        if has_pert_topo(lib):
            pcon, _, base, ptopo, dq, dx = check.sw_pert_topo_inputs(nel, s, dtype, "cpu")
            fcon, _, fbase, fdq, _ = check.sw_pert_inputs(nel, s, dtype, "cpu")
            for mode, kw in {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=check.DT),
                             "stage_x": dict(x=dx, a=0.75, b=0.25, cdt=0.25 * check.DT)}.items():
                got = pert_topo_state_call(lib, dq, pcon, topology, base, ptopo.force, **kw)
                want = swop.sw_operator_pert_plain(dq, None, pcon, base, topology=topology, topo=ptopo, **kw)
                out["topo_plain_err"][f"{dname} pert {mode}"] = _scaled_err(got, want)
                zeros = pert_topo_state_call(lib, fdq, fcon, topology, fbase, torch.zeros_like(ptopo.force), **kw)
                out["pert_topo_bits"] = out["pert_topo_bits"] and torch.equal(
                    zeros, state_call(lib, fdq, fcon, topology, base=fbase, **kw))
        tcon, _, tstates, tv, _, ttopo = check.sw_topo_tangent_inputs(nel, s, dtype, "cpu")
        for point, tq in tstates.items():
            coef, jv = topo_tangent_call(lib, tq, tv, tcon, topology, ttopo)
            if both:
                pcoef, pjv = topo_tangent_call(parent, tq, tv, tcon, topology, ttopo)
                out["topo_identical"] = out["topo_identical"] and torch.equal(coef, pcoef) and torch.equal(jv, pjv)
            out["topo_plain_err"][f"{dname} jv {point}"] = _scaled_err(
                jv, swop.sw_tangent_plain(tq, tv, tcon, topology, ttopo))
            out["topo_plain_err"][f"{dname} apply {point}"] = _scaled_err(
                jv, swop.sw_tangent_apply_plain(coef, tv, tcon, topology, ttopo))
    return out


def has_tangent(lib) -> bool:
    return has_tangent_pair(lib) or hasattr(lib, "sw_tangent_state_launch")


def tangent_call(lib, q, v, con, topology, nan_fill=True):
    """J(q).v of a library: its prep then its apply, or, in a library from
    before the split, its one-call kernel."""
    if has_tangent_pair(lib):
        return tangent_apply_call(lib, tangent_prep_call(lib, q, con, topology, nan_fill), v, con, topology, nan_fill)
    return tangent_state_call(lib, q, v, con, topology, nan_fill)


def halo_call(lib, traces, topology, nan_fill=True):
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, traces.device, traces.dtype)
    halo = _alloc(traces.shape, traces, nan_fill)
    rc = lib.sw_halo_launch(1 if traces.dtype == torch.float64 else 0, topology.num_points, _ptr(traces),
                            _ptr(tab.src), _ptr(tab.flip), _ptr(tab.conv), _ptr(halo), _stream(traces))
    if rc != 0:
        raise RuntimeError(f"sw_halo_launch returned {rc}")
    return halo


def route_call(lib, q, con, topology, nan_fill=True, **kw):
    """What the state mode replaces: the edge-trace kernel, the halo kernel,
    then the operator fed their halo (three launches)."""
    halo = halo_call(lib, edges_call(lib, q, con, nan_fill), topology, nan_fill)
    return operator_call(lib, "sw_operator_launch", q, halo, con, nan_fill=nan_fill, **kw)


def has_state_mode(lib) -> bool:
    return hasattr(lib, "sw_operator_state_launch")


def state_or_route(lib, q, con, topology, **kw):
    """The state mode of ``lib``, or the route it replaces where ``lib``
    has none."""
    if has_state_mode(lib):
        return state_call(lib, q, con, topology, **kw)
    return route_call(lib, q, con, topology, **kw)


def edges_call(lib, q, con, nan_fill=True):
    import torch

    traces = _alloc((3, 4, 6, con.nel, con.s), q, nan_fill)
    rc = lib.sw_edges_launch(1 if q.dtype == torch.float64 else 0, con.s, con.nel, _ptr(q), _ptr(con.ops),
                             _ptr(traces), _stream(q))
    if rc != 0:
        raise RuntimeError(f"sw_edges_launch returned {rc}")
    return traces


def run_call(lib, q, nsteps, abc, con, topology, base=None, nan_fill=True):
    import torch

    from wxfactory_tpu_torch.ops import sw_operator as swop

    tab = swop.halo_tables(topology, q.device, q.dtype)
    out, buf1, buf2 = (_alloc(q.shape, q, nan_fill) for _ in range(3))
    tr0, tr1 = (_alloc((3, 4, 6, con.nel, con.s), q, nan_fill) for _ in range(2))
    coeffs = (ctypes.c_double * 9)(*[float(c) for row in abc for c in row])
    pb = base.tensors if base is not None else {}
    rc = lib.sw_run_launch(
        1 if q.dtype == torch.float64 else 0, con.s, con.nel, _ptr(q), _ptr(con.ops), _ptr(con.fields),
        _ptr(con.gridrot), _ptr(con.itf_x), _ptr(con.itf_y), _ptr(pb.get("q0")), _ptr(pb.get("u0")),
        _ptr(pb.get("itf0")), _ptr(pb.get("halo0")), _ptr(pb.get("rhs0")), _ptr(tab.src), _ptr(tab.flip),
        _ptr(tab.conv), _ptr(out), _ptr(buf1), _ptr(buf2), _ptr(tr0), _ptr(tr1), ctypes.cast(coeffs, ctypes.c_void_p),
        int(nsteps), _stream(q))
    if rc != 0:
        raise RuntimeError(f"sw_run_launch returned {rc}")
    return out


def _flat(result):
    return list(result) if isinstance(result, tuple) else [result]


def check_shape(libsets: dict, nel: int, s: int, run_steps: int = 2) -> dict:
    """Every library set on the same inputs at (nel, s): {"bit_identical":
    bool (None with one set), "plain_err": {tag: worst scaled distance from
    the plain version}, "cases": count}."""
    import torch

    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    cases = {}  # name -> (plain result, {tag: the library's result})
    state_route = {t: True for t in libsets}
    # J.v: keys "tag dtype"; "identical" stays None unless both libraries
    # have the same design.
    tangent = {"plain": {}, "mass": {}, "split": {}, "identical": None, "between": {}}
    for dtype in (torch.float64, torch.float32):
        dname = "f64" if dtype == torch.float64 else "f32"
        con, topology, x, y = check.case6_inputs(nel, s, dtype, "cpu")
        halo = swop.halo_from_traces(swop.edge_traces(y, con), topology)
        pcon, _, base, dq, dx = check.sw_pert_inputs(nel, s, dtype, "cpu")
        dhalo = swop.halo_from_traces(swop.edge_traces(dq, pcon), topology)
        modes = {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=check.DT),
                 "stage_x_traces": dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=20.0, emit_traces=True)}
        for mode, kw in modes.items():
            cases[f"{dname}_{mode}"] = (
                swop.sw_operator_plain(y, halo, con, **kw),
                {t: operator_call(L["sw_operator"], "sw_operator_launch", y, halo, con, **kw)
                 for t, L in libsets.items()})
            pkw = dict(kw, x=dx) if "x" in kw else kw
            cases[f"{dname}_pert_{mode}"] = (
                swop.sw_operator_pert_plain(dq, dhalo, pcon, base, **pkw),
                {t: operator_call(L["sw_operator"], "sw_operator_launch", dq, dhalo, pcon, base=base, **pkw)
                 for t, L in libsets.items()})
        state_modes = {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=check.DT),
                       "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * check.DT)}
        for mode, kw in state_modes.items():
            for name, sq, scon, sbase, skw in (
                    (f"{dname}_state_{mode}", y, con, None, kw),
                    (f"{dname}_pert_state_{mode}", dq, pcon, base, dict(kw, x=dx) if "x" in kw else kw)):
                got = {t: state_or_route(L["sw_operator"], sq, scon, topology, base=sbase, **skw)
                       for t, L in libsets.items()}
                for t, L in libsets.items():
                    if has_state_mode(L["sw_operator"]):
                        route = route_call(L["sw_operator"], sq, scon, topology, base=sbase, **skw)
                        state_route[t] = state_route[t] and torch.equal(got[t], route)
                cases[name] = (swop.sw_operator_plain(sq, None, scon, base=sbase, topology=topology, **skw), got)
        # The Jacobian action (a library from before it has none): each
        # library's J.v against the plain tangent, the prep + apply pair
        # against the split's plain versions on the same buffer, and the
        # two libraries' J.v against each other (bit for bit only where both
        # have the same design).
        tcon, _, tstates, tv, _ = check.sw_tangent_inputs(nel, s, dtype, "cpu")
        for point, tq in tstates.items():
            want = swop.sw_tangent_plain(tq, tv, tcon, topology)
            got = {t: tangent_call(L["sw_operator"], tq, tv, tcon, topology) for t, L in libsets.items()
                   if has_tangent(L["sw_operator"])}
            for t, jv in got.items():
                key = f"{t} {dname}"
                tangent["plain"][key] = max(tangent["plain"].get(key, 0.0), _scaled_err(jv, want))
                tangent["mass"][key] = max(tangent["mass"].get(key, 0.0), abs(_mass(jv, tcon) - _mass(want, tcon)))
            for t, L in libsets.items():
                lib = L["sw_operator"]
                if not has_tangent_pair(lib):
                    continue
                coef = tangent_prep_call(lib, tq, tcon, topology)
                plain_coef = swop.sw_tangent_prep_plain(tq, tcon, topology)
                rows, plain_rows = check._sw_prep_rows(coef, tcon), check._sw_prep_rows(plain_coef, tcon)
                prep = max(float((rows[k] - plain_rows[k]).abs().max() / plain_rows[k].abs().max().clamp_min(1e-300))
                           for k in rows)
                apply = _scaled_err(tangent_apply_call(lib, coef, tv, tcon, topology),
                                    swop.sw_tangent_apply_plain(coef, tv, tcon, topology))
                split = tangent["split"].setdefault(f"{t} {dname}", {"prep": 0.0, "apply": 0.0})
                split["prep"], split["apply"] = max(split["prep"], prep), max(split["apply"], apply)
            if len(got) == 2:
                (ta, a), (tb, b) = got.items()
                if has_tangent_pair(libsets[ta]["sw_operator"]) == has_tangent_pair(libsets[tb]["sw_operator"]):
                    tangent["identical"] = tangent["identical"] is not False and torch.equal(a, b)
                tangent["between"][dname] = max(tangent["between"].get(dname, 0.0), _scaled_err(a, b))
        cases[f"{dname}_edges"] = (swop.edge_traces(y, con),
                                   {t: edges_call(L["sw_operator"], y, con) for t, L in libsets.items()})
        # The checked tile of kernels/check.py (a 2x2 mesh of this sphere).
        if nel % 2 == 0:
            tcon64, tbase64, tin64, _ = check.sw_tile_inputs(nel // 2, s, 2, "cpu")
            tcon, tbase = check.cast_constants(tcon64, dtype), check.cast_constants(tbase64, dtype)
            tin = {k: v.to(dtype) for k, v in tin64.items()}
            for tname, ty, th, tb, tx in (("tile", tin["y"], tin["halo_y"], None, tin["x"]),
                                          ("tile_pert", tin["dq"], tin["halo_dq"], tbase, tin["dx"])):
                tkw = dict(x=tx, a=0.75, b=0.25, cdt=7.5, emit_traces=True, base=tb)
                cases[f"{dname}_{tname}_stage_x_traces"] = (
                    swop.sw_tile_operator_plain(ty, th, tcon, **tkw),
                    {t: operator_call(L["sw_operator"], "sw_tile_launch", ty, th, tcon, **tkw)
                     for t, L in libsets.items()})
        if s == 4:
            abc = swop.tvdrk3_abc(30.0)
            q6 = torch.as_tensor(check.sw_setup(nel, s)[4], dtype=dtype)
            for name, q, b in (("run", q6, None), ("run_pert", dq, base)):
                cases[f"{dname}_{name}"] = (
                    swop.sw_run_plain(q, run_steps, abc, pcon, topology, base=b),
                    {t: run_call(L["sw_run"], q, run_steps, abc, pcon, topology, b) for t, L in libsets.items()})
    identical, plain_err, worst = True, {t: 0.0 for t in libsets}, {}
    for name, (plain, got) in cases.items():
        results = {t: _flat(r) for t, r in got.items()}
        tags = list(results)
        for t in tags:
            for got, want in zip(results[t], _flat(plain)):
                err = float(((got - want).abs().reshape(3, -1).amax(1)
                             / want.abs().reshape(3, -1).amax(1)).max())
                plain_err[t] = max(plain_err[t], err)
                worst[f"{t}:{name}"] = err
        if len(tags) == 2:
            same = all(torch.equal(a, b) for a, b in zip(results[tags[0]], results[tags[1]]))
            if not same:
                identical = False
                print(f"  differs: {name}", file=sys.stderr)
    return {"nel": nel, "s": s, "cases": len(cases), "bit_identical": identical if len(libsets) == 2 else None,
            "state_equals_route": {t: v for t, v in state_route.items() if has_state_mode(libsets[t]["sw_operator"])},
            "plain_err": plain_err,
            "tangent_plain_err": tangent["plain"], "tangent_mass_err": tangent["mass"],
            "tangent_split_err": tangent["split"],
            "tangent_between": tangent["between"] if len(libsets) == 2 else None,
            "tangent_identical": tangent["identical"]}


def _scaled_err(got, want) -> float:
    """The largest distance of ``got`` from ``want`` scaled by each
    variable's max of ``want``."""
    return float(((got - want).abs().reshape(3, -1).amax(1) / want.abs().reshape(3, -1).amax(1)).max())


def _mass(jv, con) -> float:
    """The weighted integral of J.v's h row over the absolute one's: the
    mass a Jacobian action moves, relative."""
    from wxfactory_tpu_torch.kernels import check

    wsg = check.sw_mass_weights(check.sw_setup(con.nel, con.s)[1], con)
    h = jv[0].double()
    return float((wsg * h).sum() / (wsg * h).abs().sum())


def main(argv=None) -> int:
    import os

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", default=str(ROOT / "wxfactory_tpu_torch" / "csrc"))
    parser.add_argument("--parent", default=None, help="directory (or path prefix) of another version of "
                        + ", ".join(FILES))
    parser.add_argument("--sms", type=int, default=132, help="the SM count the shim reports")
    parser.add_argument("--shapes", default="4,2:4,3:2,4:4,4:2,7:2,8", help="nel,s shapes separated by ':'")
    args = parser.parse_args(argv)
    os.environ["SHIM_SMS"] = str(args.sms)
    import torch

    torch.set_num_threads(2)
    libsets = {"source": build(Path(args.source), "source")}
    if args.parent:
        libsets["parent"] = build(Path(args.parent), "parent")
    ok = True
    for shape in args.shapes.split(":"):
        nel, s = (int(v) for v in shape.split(","))
        if s >= 2:
            row = check_shape(libsets, nel, s)
            print(json.dumps(row), flush=True)
            ok = (ok and row["bit_identical"] is not False and row["tangent_identical"] is not False
                  and all(row["state_equals_route"].values()))
        lib = libsets["source"]["sw_operator"]
        if has_topo(lib):
            row = check_topo_shape(lib, nel, s, libsets["parent"]["sw_operator"] if args.parent else None)
            print(json.dumps(row), flush=True)
            ok = (ok and row["topo_bits"] and row.get("topo_identical") is not False
                  and row.get("pert_topo_bits") is not False)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
