"""What bounds the shallow-water element kernel on the card (the operator
of csrc/sw_operator.cu in its RHS, stage and perturbation modes, its tile
launch, and the whole-run kernel of csrc/sw_run.cu, which share the body
of csrc/sw_element.cuh): its compiler and runtime report and its time as
it is, with its face loop skipped, with no neighbour's trace
re-extrapolated from device memory (the element's own trace in its
place), with the dense divergence and correction loops cut to their
non-zero terms (a source that has them), with the metric, gridrot and
base planes read from one element (held in L1: what keeping an owned
element's constants on chip could at most gain), with the tile launch at
its largest block or at half its block, with the operator and run
kernels compiled for 4 resident blocks an SM, and with the face-flux loop
given a compile-time trip count, moved ahead of the pointwise fluxes, or
both (scheduling only: the same bits).

    python tools/sw_operator_ablation.py [--source DIR] [--parent PREFIX] [--no-ablations] [--no-bitwise]
                                         [--groups state,whole,tile,run,tangent,topo] [--jv-per-solve N]

On the machine with the card, from the root of a copy of the checkout; a
copy without the git history needs the parent's sources written first, on
a machine that has it, into the git-ignored build/ that the copy carries:

    for f in sw_element.cuh sw_operator.cu sw_run.cu; do
      git show 870a11d:wxfactory_tpu_torch/csrc/$f > build/parent_$f; done
    python tools/sw_operator_ablation.py --parent build/parent_    # on the card

``--source`` is a directory holding sw_element.cuh, sw_operator.cu and
sw_run.cu (default: the package's csrc/); ``--parent PREFIX`` names
another version of them (PREFIX + file name), built as it is, timed in
turns with the source's and, unless ``--no-bitwise``, held bit for bit
(``torch.equal``) against it at every shape and mode of chip_smoke.py's
phases 1, 17, 20 and 25. The ablations are throwaway copies of the
sources (text substitutions, not switches in the kernel), each built with
nvcc (sm_90a, ``-Xptxas -v``) into build/sw_operator_ablation/ and
called through ctypes on the current CUDA stream; a substitution that does
not apply to a source leaves that variant out (the first line says which).
Modes: (64,3) and (64,7) float64 RHS, (64,4) float32 perturbation stage +
x + traces (ablated), float32 RHS and perturbation stage at the same
shapes (as built); the tile launch (stage + x + traces, s=3) at nt = 32
and 64, float64 (ablated), float32 and float32 perturbation; the whole
run at (64,4), 20 steps and 1 step, float32 and float64 perturbation form
(ablated). Inputs are those of kernels/check.py. Time: the card's time a
call, calls queued behind a sleep kernel between two CUDA events
(``chip_smoke._device_ms``), variants in turns (each once, then in reverse
order). The state mode of the whole-sphere operator (halo=None,
``sw_operator_state_launch``) is timed in turns with the parent's route it
replaces, the edge-trace and halo kernels and then the operator fed their
halo, and with the parent's per-stage chain step (the halo kernel on the
last stage's emitted traces, then the stage emitting its traces), at
(64,3) and (64,7) float64 RHS and (64,4) float32 perturbation stage + x:
the card's time (queued behind a sleep kernel) and the median of single
calls between two CUDA events, which includes the host's launches; and,
with ``--parent``, held bit for bit against that route at every shape and
mode of the bitwise check. Prints one JSON line with the registers and
spills (``ptxas -v``) and the runtime's registers, shared memory a block
and resident blocks an SM of every operator instantiation (s = 2..8,
float32/float64, absolute/perturbation) and of the run kernel, one line of
the bitwise check, then one line per mode, and the card's name and power
limit. An ablated kernel computes garbage: only its time is read.

The tangent group times the Jacobian action's prep and apply kernels (and
the apply built for 3 resident blocks an SM, ``apply_min_blocks_3``, with
its face loop skipped, ``apply_no_face_loop``, and with its own direction
trace in place of the neighbour's, ``apply_no_neighbour_reads``, and with
every face point reading its family's first coefficients, ``apply_coef_l1``) in
turns with the parent's one-call kernel at chip_smoke.py's
TANGENT_TIMED shapes, float64 and float32, with each one's per-solve time
(prep + N applies against N one-call launches, N = ``--jv-per-solve``);
the resources line reports the tangent kernels of both sources.

The topo group times, at (64,3) float64 and float32, the kernels with
bottom topography (Williamson case 5): the absolute state mode's RHS and
the tangent prep and apply, in turns with the parent's where it has them,
and the perturbation form's state mode with topography (RHS and stage +
x) in turns with the perturbation state mode without it on case 6's base
(both sources) and, where built, with the variant whose float64
instantiation is compiled for 4 resident blocks an SM as the float32 one is
(``pert_topo_min_blocks_4``). With a parent that has the topography entries the bitwise
check also holds them (the absolute state mode in RHS, stage and stage +
x, and the tangent pair) at every shape of chip_smoke.py's phase 1, and
the resources line reports every topography instantiation.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from sw_host_shim import (  # noqa: E402
    FILES,
    edges_call,
    halo_call,
    has_pert_topo,
    has_state_mode,
    has_tangent_pair,
    has_topo,
    operator_call,
    pert_topo_state_call,
    run_call,
    state_call,
    state_or_route,
    tangent_apply_call,
    tangent_prep_call,
    tangent_state_call,
    topo_state_call,
    topo_tangent_call,
)

OUT = ROOT / "build" / "sw_operator_ablation"
ELEMENT = "sw_element.cuh"


def _sub(src: str, pattern: str, repl: str, what: str, count: int = 0):
    out, n = re.subn(pattern, repl, src, count=count)
    if n == 0:
        raise ValueError(f"no {what} found in the source")
    return out


def _no_face_loop(files: dict) -> dict:
    # The first per-face loop of the element body: the face fluxes.
    return dict(files, **{ELEMENT: _sub(files[ELEMENT], r"fi < NF; fi \+= S2\)", "fi < 0; fi += S2)",
                                        "face loop", count=1)})


def _no_neighbour_reads(files: dict) -> dict:
    # The neighbour's trace, re-extrapolated from device memory, replaced by
    # the element's own trace (dense dot_col or face_trace).
    src = files[ELEMENT]
    src, n_old = re.subn(r"dot_col<T, S2>\(A\.q \+ v \* nq \+ \(long long\)nb_elem \* S2, sEE, NF, nb_col\)",
                         "dot_col<T, S2>(sQ + v * S2, sEE, NF, fi)", src)
    src, n_new = re.subn(r"face_trace<T, S>\(A\.q \+ v \* nq \+ \(long long\)nb_elem \* S2, sExt \+ nb_side \* S, "
                         r"nb_side, k\)", "face_trace<T, S>(sQ + v * S2, sExt + side * S, side, k)", src)
    if n_old + n_new == 0:
        raise ValueError("no neighbour re-extrapolation found in the source")
    return dict(files, **{ELEMENT: src})


SPARSE = """      const int jy = j / S, jx = j - jy * S;
      for (int m = 0; m < S; ++m) div = fmadd(sF[v * S2 + jy * S + m], sDD[(jy * S + m) * S2 + j], div);
      for (int m = 0; m < S; ++m)
        div = fmadd(sF[(3 + v) * S2 + m * S + jx], sDD[(S2 + m * S + jx) * S2 + j], div);
      T corr = T(0);
      corr = fmadd(sFl[v * NF + jy], sCC[jy * S2 + j], corr);
      corr = fmadd(sFl[v * NF + S + jy], sCC[(S + jy) * S2 + j], corr);
      corr = fmadd(sFl[v * NF + 2 * S + jx], sCC[(2 * S + jx) * S2 + j], corr);
      corr = fmadd(sFl[v * NF + 3 * S + jx], sCC[(3 * S + jx) * S2 + j], corr);
"""


def _sparse_products(files: dict) -> dict:
    # The dense divergence (2 s^2 terms) and correction (4 s terms) loops cut
    # to the terms the Kronecker structure leaves non-zero, read from the
    # same dense blocks.
    pattern = (r"      for \(int i = 0; i < S2; \+\+i\) div = fmadd\(sF\[v \* S2 \+ i\], sDD\[i \* S2 \+ j\], div\);\n"
               r"      for \(int i = 0; i < S2; \+\+i\) div = fmadd\(sF\[\(3 \+ v\) \* S2 \+ i\], "
               r"sDD\[\(S2 \+ i\) \* S2 \+ j\], div\);\n"
               r"      T corr = T\(0\);\n"
               r"      for \(int fi = 0; fi < NF; \+\+fi\) corr = fmadd\(sFl\[v \* NF \+ fi\], sCC\[fi \* S2 \+ j\], corr\);\n")
    return dict(files, **{ELEMENT: _sub(files[ELEMENT], pattern, lambda m: SPARSE, "dense divergence loop")})


def _metric_l1(files: dict) -> dict:
    # Every element reads the metric, gridrot and base planes of element 0
    # (lines that stay in L1): the most that keeping an element's constants
    # in shared memory across stages could gain.
    src = files[ELEMENT]
    n = 0
    for pattern, repl in ((r"A\.fields \+ \(long long\)pe \* S2 \+ j", "A.fields + j"),
                          (r"A\.gridrot\[pt\]", "A.gridrot[j]"),
                          (r"A\.(q0|u0)\[((?:2 \* )?nq \+ )?pt\]", r"A.\1[\2j]"),
                          (r"A\.rhs0\[v \* nq \+ pt\]", "A.rhs0[v * nq + j]"),
                          (r"\(long long\)elem \* NF \+ fi\]", "fi]"),
                          (r"\(long long\)nb_elem \* NF \+ ", "")):
        src, k = re.subn(pattern, repl, src)
        n += k
    if n == 0:
        raise ValueError("no metric read found in the source")
    return dict(files, **{ELEMENT: src})


def _eb_max(files: dict) -> dict:
    # The operator launch at its largest block whatever its element count.
    return dict(files, **{"sw_operator.cu": _sub(files["sw_operator.cu"],
                                                 r"const int eb = elements_per_block\(nelem, Sh::EB, sms\);",
                                                 "const int eb = Sh::EB; (void)sms;", "elements-per-block choice",
                                                 count=1)})


def _eb_half(files: dict) -> dict:
    # Smaller blocks where a launch is small: two blocks an SM at least.
    return dict(files, **{"sw_operator.cu": _sub(files["sw_operator.cu"],
                                                 r"elements_per_block\(nelem, Sh::EB, sms\)",
                                                 "elements_per_block(nelem, Sh::EB, 2 * sms)",
                                                 "elements-per-block choice", count=1)})


def _min_blocks(files: dict) -> dict:
    # The operator and run kernels compiled for 4 resident blocks an SM
    # (a register cap of 64 a thread at 256 threads).
    out = {}
    for name in ("sw_operator.cu", "sw_run.cu"):
        out[name] = _sub(files[name], r"__launch_bounds__\(swk::kThreads(?:, [^()]*)?\)\s*(sw_operator_kernel|sw_run_kernel)",
                         r"__launch_bounds__(swk::kThreads, 4) \1", "operator kernel's launch bounds")
    return dict(files, **out)


def _pert_topo_min_blocks(files: dict) -> dict:
    # The float64 perturbation kernel with topography compiled for 4
    # resident blocks an SM, as its float32 instantiation is.
    return dict(files, **{"sw_operator.cu": _sub(
        files["sw_operator.cu"], r"__launch_bounds__\(swk::kThreads\) sw_operator_pert_topo_kernel",
        "__launch_bounds__(swk::kThreads, 4) sw_operator_pert_topo_kernel", "perturbation topography kernel's "
        "launch bounds", count=1)})


def _face_loop_unrolled(files: dict) -> dict:
    # The face-flux loop with its compile-time trip count (one pass for
    # s >= 4, two for s = 2, 3), so its loads can be scheduled with the
    # pointwise part's.
    return dict(files, **{ELEMENT: _sub(files[ELEMENT], r"    for \(int fi = j; fi < NF; fi \+= S2\) \{\n",
                                        lambda m: "#pragma unroll\n    for (int fr = 0; fr < (NF + S2 - 1) / S2; ++fr) {\n"
                                                  "      const int fi = j + fr * S2;\n      if (fi >= NF) break;\n",
                                        "face loop", count=1)})


def _face_loop_first(files: dict) -> dict:
    # The face-flux loop moved ahead of the pointwise fluxes (independent
    # work; its neighbour rows are then the first loads a thread issues).
    src = files[ELEMENT]
    try:
        p0 = src.index("    const T* fld = A.fields")
        f0 = src.index("    const int npts = nel * S;\n    for (int fi = j; fi < NF; fi += S2) {")
        f1 = src.index("  }\n  __syncthreads();\n\n  // --- Interior divergence")
    except ValueError:
        raise ValueError("no face loop after the pointwise fluxes found in the source") from None
    return dict(files, **{ELEMENT: src[:p0] + src[f0:f1] + "\n" + src[p0:f0] + src[f1:]})


def _apply_min_blocks(files: dict) -> dict:
    # The tangent apply kernel compiled for 3 resident blocks an SM (80
    # registers a thread at 256 threads).
    return dict(files, **{"sw_operator.cu": _sub(files["sw_operator.cu"],
                                                 r"__launch_bounds__\(swk::kThreads\) sw_tangent_apply_kernel",
                                                 "__launch_bounds__(swk::kThreads, 3) sw_tangent_apply_kernel",
                                                 "tangent apply kernel's launch bounds")})


def _apply_no_face_loop(files: dict) -> dict:
    # The tangent apply's face loop skipped (no flux tangent computed).
    return dict(files, **{"sw_operator.cu": _sub(files["sw_operator.cu"], r"it < n_items; it \+= blockDim\.x\)",
                                                 "it < 0; it += blockDim.x)", "tangent apply's face loop")})


def _apply_no_neighbour_reads(files: dict) -> dict:
    # The tangent apply's neighbour direction traces (re-extrapolated from v
    # in device memory, or the halo at a panel edge) replaced by its own.
    src = _sub(files["sw_operator.cu"], r"    if \(at_edge\) \{\n      swk::state_halo_point<T, S>\(A\.v, ",
               "    if (false) {\n      swk::state_halo_point<T, S>(A.v, ", "tangent apply's halo branch")
    src = _sub(src, r"swk::face_trace<T, S>\(A\.v \+ v \* nq \+ \(long long\)nb_elem \* S2, sExt \+ nb_side \* S, "
                    r"nb_side, k\)", "swk::face_trace<T, S>(sVe + v * S2, sExt + side * S, side, k)",
               "tangent apply's neighbour re-extrapolation")
    return dict(files, **{"sw_operator.cu": src})


def _apply_coef_l1(files: dict) -> dict:
    # Every face point of the tangent apply reads the coefficients of its
    # family's first interface points (lines that stay in L1): what the
    # interface coefficients' device-memory traffic costs.
    return dict(files, **{"sw_operator.cu": _sub(files["sw_operator.cu"],
                                                 r"const T\* src = A\.coef \+ lay\.face\(is_x\) \+ cidx;",
                                                 "const T* src = A.coef + lay.face(is_x) + k; (void)cidx;",
                                                 "tangent apply's coefficient read")})


# Variants of the tangent pair, timed in the tangent group only.
TANGENT_VARIANTS = ("apply_min_blocks_3", "apply_no_face_loop", "apply_no_neighbour_reads", "apply_coef_l1")

VARIANTS = {
    "as_built": lambda f: f,
    "apply_min_blocks_3": _apply_min_blocks,
    "apply_no_face_loop": _apply_no_face_loop,
    "apply_no_neighbour_reads": _apply_no_neighbour_reads,
    "apply_coef_l1": _apply_coef_l1,
    "no_face_loop": _no_face_loop,
    "no_neighbour_reads": _no_neighbour_reads,
    "sparse_products": _sparse_products,
    "metric_l1": _metric_l1,
    "eb_max": _eb_max,
    "eb_half": _eb_half,
    "min_blocks_4": _min_blocks,
    "pert_topo_min_blocks_4": _pert_topo_min_blocks,
    "face_loop_unrolled": _face_loop_unrolled,
    "face_loop_first": _face_loop_first,
    "face_loop_first_unrolled": lambda f: _face_loop_unrolled(_face_loop_first(f)),
}

# What the runtime reports of an instantiation, appended to a source set
# without the resources entries (the kernels of 870a11d: dense EE/DD/CC in
# shared memory, one block size).
PARENT_OPERATOR_RESOURCES = r"""
namespace {
template <typename K>
cudaError_t ablation_resources(K kernel, int threads, size_t smem, int* info) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)smem;
  info[3] = blocks;
  info[4] = threads;
  return err;
}
}  // namespace
"""
PARENT_OPERATOR_ENTRY = r"""
namespace {
template <typename T, bool PERT>
cudaError_t ablation_dispatch(int s, int* info) {
#define AB_CASE(S) \
  case S: return ablation_resources(sw_operator_kernel<T, S, PERT>, Shape<S>::THREADS, Shape<S>::smem_bytes(sizeof(T)), info);
  switch (s) {
    AB_CASE(2) AB_CASE(3) AB_CASE(4) AB_CASE(5) AB_CASE(6) AB_CASE(7) AB_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef AB_CASE
}
}  // namespace
extern "C" int sw_operator_resources(int is_f64, int s, int pert, int* info) {
  if (is_f64) return (int)(pert ? ablation_dispatch<double, true>(s, info) : ablation_dispatch<double, false>(s, info));
  return (int)(pert ? ablation_dispatch<float, true>(s, info) : ablation_dispatch<float, false>(s, info));
}
"""
PARENT_RUN_ENTRY = r"""
extern "C" int sw_run_resources(int is_f64, int pert, int* info) {
  using Sh = Shape<4>;
  if (is_f64)
    return (int)(pert ? ablation_resources(sw_run_kernel<double, 4, true>, Sh::THREADS, Sh::smem_bytes(8), info)
                      : ablation_resources(sw_run_kernel<double, 4, false>, Sh::THREADS, Sh::smem_bytes(8), info));
  return (int)(pert ? ablation_resources(sw_run_kernel<float, 4, true>, Sh::THREADS, Sh::smem_bytes(4), info)
                    : ablation_resources(sw_run_kernel<float, 4, false>, Sh::THREADS, Sh::smem_bytes(4), info));
}
"""


def _with_resources(files: dict) -> dict:
    if "sw_operator_resources" in files["sw_operator.cu"]:
        return files
    return dict(files, **{"sw_operator.cu": files["sw_operator.cu"] + PARENT_OPERATOR_RESOURCES + PARENT_OPERATOR_ENTRY,
                          "sw_run.cu": files["sw_run.cu"] + PARENT_OPERATOR_RESOURCES + PARENT_RUN_ENTRY})


def _read(prefix: str) -> dict:
    """The three files of a source set: ``prefix`` a directory or a path
    prefix (``build/parent_`` for build/parent_sw_element.cuh, ...)."""
    base = Path(prefix)
    return {name: ((base / name) if base.is_dir() else Path(prefix + name)).read_text() for name in FILES}


def build_variants(source: str, parent=None, ablations: bool = True, only=None):
    """{name: {"sw_operator", "sw_run": ctypes library}} of the source's
    variants (all, none with ``ablations`` False, or the names in ``only``)
    and the parent's, every nvcc process started together; {name: nvcc
    log}; and {name: why left out}."""
    from wxfactory_tpu_torch.kernels import build

    files = _read(source)
    sets, skipped = {}, {}
    variants = dict(VARIANTS) if ablations else {"as_built": VARIANTS["as_built"]}
    if only is not None:
        variants = {n: f for n, f in variants.items() if n == "as_built" or n in only}
    for name, edit in variants.items():
        try:
            edited = edit(files)
        except ValueError as err:
            skipped[name] = str(err)
            continue
        if name != "as_built" and edited == files:
            skipped[name] = "the substitution changes nothing"
            continue
        sets[name] = _with_resources(edited)
    if parent is not None:
        sets["parent"] = _with_resources(_read(parent))
    procs = {}
    for name, fs in sets.items():
        work = OUT / name
        work.mkdir(parents=True, exist_ok=True)
        for fname, text in fs.items():
            (work / fname).write_text(text)
        for lib in ("sw_operator", "sw_run"):
            so = work / f"lib{lib}.so"
            cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o", str(so), str(work / f"{lib}.cu")]
            procs[(name, lib)] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                                  so)
    libs, logs = {}, {}
    for (name, lib), (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}/{lib}:\n{log}")
        logs[name] = logs.get(name, "") + log
        handle = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in build.SIGNATURES[lib].items():
            if hasattr(handle, fn):
                getattr(handle, fn).restype, getattr(handle, fn).argtypes = restype, argtypes
        if lib == "sw_operator" and not has_tangent_pair(handle) and hasattr(handle, "sw_tangent_resources"):
            # The one-call kernel's report (a parent from before the split): is_f64, s, int[5] out.
            handle.sw_tangent_resources.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        libs.setdefault(name, {})[lib] = handle
    return libs, logs, skipped


def resources(libset):
    """Registers, spill bytes, dynamic shared memory, resident blocks an SM
    and threads a block of every operator instantiation and of the run
    kernel, as the runtime reports them."""
    keys = ("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads")
    rows = []
    for f64 in (1, 0):
        for pert in (0, 1):
            entries = [("operator", s, lambda info, s=s: libset["sw_operator"].sw_operator_resources(f64, s, pert, info))
                       for s in range(2, 9)]
            entries.append(("run", 4, lambda info: libset["sw_run"].sw_run_resources(f64, pert, info)))
            for kernel, s, fn in entries:
                info = (ctypes.c_int * 5)()
                rc = fn(ctypes.cast(info, ctypes.c_void_p))
                if rc != 0:
                    raise RuntimeError(f"{kernel} resources failed: CUDA error {rc}")
                vals = dict(zip(keys, info))
                rows.append({"kernel": kernel, "dtype": "float64" if f64 else "float32",
                             "form": "perturbation" if pert else "absolute", "s": s, **vals,
                             "threads_per_sm": vals["blocks_per_sm"] * vals["threads"]})
        lib = libset["sw_operator"]
        for kernel, entry in (("operator_topo", "sw_operator_topo_resources"),
                              ("operator_pert_topo", "sw_operator_pert_topo_resources")):
            if not hasattr(lib, entry):
                continue
            getattr(lib, entry).argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            for s in range(2, 9):
                info = (ctypes.c_int * 5)()
                rc = getattr(lib, entry)(f64, s, ctypes.cast(info, ctypes.c_void_p))
                if rc != 0:
                    raise RuntimeError(f"{kernel} resources failed: CUDA error {rc}")
                vals = dict(zip(keys, info))
                rows.append({"kernel": kernel, "dtype": "float64" if f64 else "float32",
                             "form": "perturbation" if kernel == "operator_pert_topo" else "absolute", "s": s,
                             **vals, "threads_per_sm": vals["blocks_per_sm"] * vals["threads"]})
        pair = has_tangent_pair(lib)
        if not pair and not hasattr(lib, "sw_tangent_resources"):
            continue
        for s in range(2, 9):
            for kernel in (((0, 1, 2, 3) if has_topo(lib) else (0, 1)) if pair else (None,)):
                info = (ctypes.c_int * 5)()
                ptr = ctypes.cast(info, ctypes.c_void_p)
                rc = lib.sw_tangent_resources(f64, s, kernel, ptr) if pair else lib.sw_tangent_resources(f64, s, ptr)
                if rc != 0:
                    raise RuntimeError(f"tangent resources failed: CUDA error {rc}")
                vals = dict(zip(keys, info))
                rows.append({"kernel": ("tangent_prep", "tangent_apply", "tangent_prep_topo",
                                        "tangent_apply_topo")[kernel] if pair else "tangent_one_call",
                             "dtype": "float64" if f64 else "float32", "form": "absolute", "s": s, **vals,
                             "threads_per_sm": vals["blocks_per_sm"] * vals["threads"]})
    return rows


def _dname(dtype):
    return str(dtype).replace("torch.", "")


def whole_sphere_modes(torch):
    """[(mode, ablate, call(libset) -> result)] of the operator launch."""
    from wxfactory_tpu_torch.kernels import check

    from wxfactory_tpu_torch.ops import sw_operator as swop

    modes = []
    for nel, s in ((64, 3), (64, 4), (64, 7)):
        for dtype in (torch.float64, torch.float32):
            tag = f"({nel},{s}) {_dname(dtype)}"
            con, topology, x, y = check.case6_inputs(nel, s, dtype, "cuda")
            halo = swop.halo_from_traces(swop.edge_traces(y, con), topology)
            pcon, _, base, dq, dx = check.sw_pert_inputs(nel, s, dtype, "cuda")
            dhalo = swop.halo_from_traces(swop.edge_traces(dq, pcon), topology)
            stage = dict(a=0.75, b=0.25, cdt=7.5, emit_traces=True)
            rhs_ablate = dtype == torch.float64 and s != 4
            modes.append((f"{tag} rhs", rhs_ablate,
                          lambda L, y=y, halo=halo, con=con: operator_call(L["sw_operator"], "sw_operator_launch", y,
                                                                           halo, con, nan_fill=False)))
            modes.append((f"{tag} pert_stage_x_traces", dtype == torch.float32 and s in (3, 4),
                          lambda L, dq=dq, dhalo=dhalo, pcon=pcon, base=base, dx=dx, stage=stage: operator_call(
                              L["sw_operator"], "sw_operator_launch", dq, dhalo, pcon, x=dx, base=base, nan_fill=False,
                              **stage)))
    return modes


def tile_modes(torch, nt, s=3, nel=64):
    """[(mode, ablate, call)] of the tile launch (stage + x + traces) at the
    checked tile of a sphere of nel (N = nel / nt): phase 28's tiles."""
    from wxfactory_tpu_torch.kernels import check

    con64, base64, inputs64, _ = check.sw_tile_inputs(nt, s, nel // nt, "cuda")
    modes = []
    for dtype, pert in ((torch.float64, False), (torch.float32, False), (torch.float32, True)):
        con, base = check.cast_constants(con64, dtype), check.cast_constants(base64, dtype)
        inp = {k: v.to(dtype) for k, v in inputs64.items()}
        y, h, x = (inp["dq"], inp["halo_dq"], inp["dx"]) if pert else (inp["y"], inp["halo_y"], inp["x"])
        kw = dict(x=x, a=0.75, b=0.25, cdt=2.5, emit_traces=True, base=base if pert else None, nan_fill=False)
        tag = f"tile nt={nt} {_dname(dtype)}{' pert' if pert else ''} stage_x_traces"
        modes.append((tag, dtype == torch.float64,
                      lambda L, y=y, h=h, con=con, kw=kw: operator_call(L["sw_operator"], "sw_tile_launch", y, h, con,
                                                                        **kw)))
    return modes


def run_modes(torch, nel=64):
    """[(mode, ablate, call)] of the whole run at (nel, 4), perturbation
    form, 20 steps and 1 step."""
    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    modes = []
    abc = swop.tvdrk3_abc(30.0)
    for dtype in (torch.float32, torch.float64):
        con, topology, base, dq, _ = check.sw_pert_inputs(nel, 4, dtype, "cuda")
        for nsteps in (20, 1):
            modes.append((f"run ({nel},4) {_dname(dtype)} pert {nsteps} steps", True,
                          lambda L, dq=dq, n=nsteps, con=con, topology=topology, base=base: run_call(
                              L["sw_run"], dq, n, abc, con, topology, base, nan_fill=False)))
    return modes


def state_group(torch, libs):
    """The state mode (one launch) against the routes it replaces, in turns:
    rows of {"mode", "ms": {variant: [card ms]}, "event_ms": {variant:
    [median ms of single calls]}}. Variants: ``state`` (the source's state
    mode), ``source_route`` (the source's edge, halo and operator kernels),
    and with a parent ``parent_route`` (the same three of the parent) and,
    for a stage, ``parent_chain_stage`` (the parent's halo kernel on given
    traces, then its stage emitting the output's traces: what the parent's
    chain launched a stage)."""
    from chip_smoke import _device_ms, _event_times
    from wxfactory_tpu_torch.kernels import check

    import statistics

    rows = []
    for nel, s, dtype, pert in ((64, 3, torch.float64, False), (64, 4, torch.float32, True),
                                (64, 7, torch.float64, False)):
        if pert:
            con, topology, base, q, x = check.sw_pert_inputs(nel, s, dtype, "cuda")
            kw = dict(x=x, a=0.75, b=0.25, cdt=7.5, base=base)
            mode = f"({nel},{s}) {_dname(dtype)} pert_stage_x"
        else:
            con, topology, _, q = check.case6_inputs(nel, s, dtype, "cuda")
            kw = {}
            mode = f"({nel},{s}) {_dname(dtype)} rhs"
        new = libs["as_built"]["sw_operator"]
        variants = {"state": lambda: state_or_route(new, q, con, topology, nan_fill=False, **kw)}
        if not has_state_mode(new):
            raise RuntimeError("the source has no state mode")
        variants["source_route"] = lambda: operator_call(
            new, "sw_operator_launch", q, halo_call(new, edges_call(new, q, con, False), topology, False), con,
            nan_fill=False, **kw)
        if "parent" in libs:
            old = libs["parent"]["sw_operator"]
            variants["parent_route"] = lambda: state_or_route(old, q, con, topology, nan_fill=False, **kw)
            if "cdt" in kw:
                traces = edges_call(old, q, con, False)
                variants["parent_chain_stage"] = lambda: operator_call(
                    old, "sw_operator_launch", q, halo_call(old, traces, topology, False), con, nan_fill=False,
                    emit_traces=True, **kw)
        for fn in variants.values():
            fn()
        torch.cuda.synchronize()
        names = list(variants)
        ms = {n: [] for n in names}
        event = {n: [] for n in names}
        for n in names + names[::-1]:
            ms[n].append(_device_ms(torch, variants[n], 20))
            event[n].append(statistics.median(_event_times(torch, variants[n], n=20)))
        rows.append({"mode": mode, "ms": ms, "event_ms": event})
    return rows


def topo_group(torch, libs):
    """The kernels with bottom topography at (64,3), float64 and float32, in
    turns: rows of {"mode", "ms": {variant: [card ms]}}. Variants: ``source``
    and, where the parent has the entry, ``parent`` (the absolute state
    mode's RHS, the tangent prep and apply, on case 5); for the perturbation
    form with topography, ``pert_topo`` (the source's, on case 5's base)
    beside ``pert`` and ``parent_pert`` (the perturbation state mode without
    topography on case 6's base)."""
    from chip_smoke import _device_ms
    from wxfactory_tpu_torch.kernels import check

    new = libs["as_built"]["sw_operator"]
    old = libs["parent"]["sw_operator"] if "parent" in libs else None
    rows = []
    nel, s = 64, 3
    for dtype in (torch.float64, torch.float32):
        tag = f"({nel},{s}) {_dname(dtype)}"
        con, topology, topo, _, y, _ = check.sw_topo_inputs(nel, s, dtype, "cuda")
        tcon, _, states, v, _, ttopo = check.sw_topo_tangent_inputs(nel, s, dtype, "cuda")
        q = states["case5"]
        groups = {f"{tag} topo_rhs": {lib_name: (lambda L=L: topo_state_call(L, y, con, topology, topo,
                                                                              nan_fill=False))
                                      for lib_name, L in (("source", new), ("parent", old))
                                      if L is not None and has_topo(L)}}
        groups[f"{tag} topo_tangent_prep_apply"] = {
            lib_name: (lambda L=L: topo_tangent_call(L, q, v, tcon, topology, ttopo, nan_fill=False))
            for lib_name, L in (("source", new), ("parent", old)) if L is not None and has_topo(L)}
        pcon, _, base, topo_p, dq, dx = check.sw_pert_topo_inputs(nel, s, dtype, "cuda")
        fcon, _, fbase, fdq, fx = check.sw_pert_inputs(nel, s, dtype, "cuda")
        for mode, kw, fkw in (("rhs", {}, {}), ("stage_x", dict(x=dx, a=0.75, b=0.25, cdt=7.5),
                                                 dict(x=fx, a=0.75, b=0.25, cdt=7.5))):
            variants = {"pert": lambda kw=fkw: state_call(new, fdq, fcon, topology, base=fbase, nan_fill=False, **kw)}
            if has_pert_topo(new):
                variants["pert_topo"] = lambda kw=kw: pert_topo_state_call(new, dq, pcon, topology, base, topo_p.force,
                                                                            nan_fill=False, **kw)
            if "pert_topo_min_blocks_4" in libs:
                capped = libs["pert_topo_min_blocks_4"]["sw_operator"]
                variants["pert_topo_min_blocks_4"] = lambda kw=kw: pert_topo_state_call(
                    capped, dq, pcon, topology, base, topo_p.force, nan_fill=False, **kw)
            if old is not None:
                variants["parent_pert"] = lambda kw=fkw: state_call(old, fdq, fcon, topology, base=fbase,
                                                                     nan_fill=False, **kw)
            groups[f"{tag} pert_state_{mode}"] = variants
        for mode, variants in groups.items():
            for fn in variants.values():
                fn()
            torch.cuda.synchronize()
            names = list(variants)
            ms = {n: [] for n in names}
            for n in names + names[::-1]:
                ms[n].append(_device_ms(torch, variants[n], 20))
            rows.append({"mode": mode, "ms": ms})
    return rows


def tangent_group(torch, libs, n_jv: int):
    """The tangent pair against the parent's one-call kernel, in turns, at
    chip_smoke.py's timed tangent shapes: rows of {"mode", "ms": {variant:
    [card ms]}, "per_solve_ms"}. Variants: ``prep`` and ``apply`` of the
    source (and the apply of each TANGENT_VARIANTS build), and with a
    parent ``parent_one_call`` (its J.v in one launch), or
    ``parent_prep`` and ``parent_apply`` where the parent has the pair.
    ``per_solve_ms``: one Krylov solve of ``n_jv`` Jacobian actions at one
    linearisation point, prep + n_jv x apply against the parent's (the
    medians of the turns)."""
    import statistics

    import chip_smoke
    from chip_smoke import _device_ms
    from wxfactory_tpu_torch.kernels import check

    rows = []
    for nel, s in chip_smoke.TANGENT_TIMED:
        for dtype in (torch.float64, torch.float32):
            con, topology, states, v, _ = check.sw_tangent_inputs(nel, s, dtype, "cuda")
            q = states["case6"]
            new = libs["as_built"]["sw_operator"]
            coef = tangent_prep_call(new, q, con, topology, nan_fill=False)
            variants = {"prep": lambda: tangent_prep_call(new, q, con, topology, nan_fill=False),
                        "apply": lambda: tangent_apply_call(new, coef, v, con, topology, nan_fill=False)}
            for name in TANGENT_VARIANTS:
                if name in libs:
                    lib = libs[name]["sw_operator"]
                    variants[name] = lambda lib=lib: tangent_apply_call(lib, coef, v, con, topology, nan_fill=False)
            if "parent" in libs:
                old = libs["parent"]["sw_operator"]
                if has_tangent_pair(old):
                    old_coef = tangent_prep_call(old, q, con, topology, nan_fill=False)
                    variants["parent_prep"] = lambda: tangent_prep_call(old, q, con, topology, nan_fill=False)
                    variants["parent_apply"] = lambda: tangent_apply_call(old, old_coef, v, con, topology,
                                                                          nan_fill=False)
                else:
                    variants["parent_one_call"] = lambda: tangent_state_call(old, q, v, con, topology, nan_fill=False)
            for fn in variants.values():
                fn()
            torch.cuda.synchronize()
            names = list(variants)
            ms = {n: [] for n in names}
            for n in names + names[::-1]:
                ms[n].append(_device_ms(torch, variants[n], 20))
            med = {n: statistics.median(t) for n, t in ms.items()}
            per_solve = {"n_jv": n_jv, "pair": med["prep"] + n_jv * med["apply"]}
            if "parent_one_call" in med:
                per_solve["parent"] = n_jv * med["parent_one_call"]
            elif "parent_prep" in med:
                per_solve["parent"] = med["parent_prep"] + n_jv * med["parent_apply"]
            rows.append({"mode": f"({nel},{s}) {_dname(dtype)} case6", "ms": ms, "per_solve_ms": per_solve})
    return rows


def time_modes(torch, libs, modes, slow=False):
    from chip_smoke import _device_ms

    rows = []
    for mode, ablate, call in modes:
        names = [n for n in libs if (ablate and n not in TANGENT_VARIANTS) or n in ("as_built", "parent")]
        calls = {n: (lambda n=n: call(libs[n])) for n in names}
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        times = {n: [] for n in names}
        for n in names + names[::-1]:
            times[n].append(_device_ms(torch, calls[n], 3 if slow else 20))
        rows.append({"mode": mode, "ms": {n: sorted(t) for n, t in times.items()}})
    return rows


def bitwise(torch, libs):
    """The source's kernels against the parent's, ``torch.equal``, at every
    shape and mode of chip_smoke.py's phases 1, 17, 20 and 25: {"cases",
    "identical", "differ": [names]}."""
    import chip_smoke
    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    new, old = libs["as_built"], libs["parent"]
    cases, differ = 0, []

    def same(name, call):
        nonlocal cases
        a, b = call(new), call(old)
        a, b = (list(a) if isinstance(a, tuple) else [a]), (list(b) if isinstance(b, tuple) else [b])
        cases += 1
        if not all(torch.equal(u, v) for u, v in zip(a, b)):
            differ.append(name)

    shapes = sorted(set(chip_smoke.SHAPES) | set(chip_smoke.SW_PERT_SHAPES) | {(64, 4), (64, 7)})
    for nel, s in shapes:
        for dtype in (torch.float64, torch.float32):
            tag = f"({nel},{s}) {_dname(dtype)}"
            con, topology, x, y = check.case6_inputs(nel, s, dtype, "cuda")
            halo = swop.halo_from_traces(swop.edge_traces(y, con), topology)
            modes = {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=check.DT),
                     "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * check.DT),
                     "stage_x_traces": dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=(2.0 / 3.0) * check.DT,
                                            emit_traces=True)}
            for mode, kw in modes.items():
                same(f"{tag} {mode}", lambda L, kw=kw: operator_call(L["sw_operator"], "sw_operator_launch", y, halo,
                                                                       con, **kw))
                if not kw.get("emit_traces"):  # the state mode (the parent: its edge, halo, operator route)
                    same(f"{tag} state_{mode}", lambda L, kw=kw: state_or_route(L["sw_operator"], y, con, topology,
                                                                                 **kw))
            same(f"{tag} edges", lambda L: edges_call(L["sw_operator"], y, con))
            pcon, _, base, dq, dx = check.sw_pert_inputs(nel, s, dtype, "cuda")
            dhalo = swop.halo_from_traces(swop.edge_traces(dq, pcon), topology)
            for mode, kw in check._sw_pert_modes(dx).items():
                same(f"{tag} pert_{mode}", lambda L, kw=kw: operator_call(L["sw_operator"], "sw_operator_launch", dq,
                                                                            dhalo, pcon, base=base, **kw))
                if not kw.get("emit_traces"):
                    same(f"{tag} pert_state_{mode}", lambda L, kw=kw: state_or_route(
                        L["sw_operator"], dq, pcon, topology, base=base, **kw))
    abc = swop.tvdrk3_abc(30.0)
    for nel in (32, 64):
        for dtype in (torch.float64, torch.float32):
            con, topology, base, dq, _ = check.sw_pert_inputs(nel, 4, dtype, "cuda")
            q0 = torch.as_tensor(check.sw_setup(nel, 4)[4], dtype=dtype, device="cuda")
            for pert in (False, True):
                q, b = (dq, base) if pert else (q0, None)
                for nsteps in (1, 2, 3) + ((chip_smoke.RUN_STEPS,) if nel == 64 else ()):
                    same(f"run ({nel},4) {_dname(dtype)} {'pert ' if pert else ''}{nsteps}",
                         lambda L, q=q, b=b, n=nsteps: run_call(L["sw_run"], q, n, abc, con, topology, b))
    if has_topo(new["sw_operator"]) and has_topo(old["sw_operator"]):
        for nel, s in chip_smoke.SHAPES:
            for dtype in (torch.float64, torch.float32):
                tag = f"({nel},{s}) {_dname(dtype)}"
                con, topology, topo, x, y, _ = check.sw_topo_inputs(nel, s, dtype, "cuda")
                for mode, kw in {"rhs": {}, "stage": dict(a=0.0, b=1.0, cdt=check.DT),
                                 "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * check.DT)}.items():
                    same(f"{tag} topo_state_{mode}", lambda L, kw=kw: topo_state_call(
                        L["sw_operator"], y, con, topology, topo, **kw))
                tcon, _, states, v, _, ttopo = check.sw_topo_tangent_inputs(nel, s, dtype, "cuda")
                for point, q in states.items():
                    same(f"{tag} topo_tangent {point}", lambda L, q=q: topo_tangent_call(
                        L["sw_operator"], q, v, tcon, topology, ttopo))
    for nt, s, n in check.SW_TILE_SHAPES:
        con64, base64, inputs64, _ = check.sw_tile_inputs(nt, s, n, "cuda")
        for dtype in (torch.float64, torch.float32):
            con, base = check.cast_constants(con64, dtype), check.cast_constants(base64, dtype)
            inputs = {k: v.to(dtype) for k, v in inputs64.items()}
            for pert in (False, True):
                for mode, y, h, kw in check._tile_modes(inputs, check.DT, pert):
                    same(f"tile ({nt},{s},{n}) {_dname(dtype)} {mode}",
                         lambda L, y=y, h=h, kw=kw, b=base if pert else None: operator_call(
                             L["sw_operator"], "sw_tile_launch", y, h, con, base=b, **kw))
    torch.cuda.synchronize()
    return {"cases": cases, "identical": cases - len(differ), "differ": differ}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", default=str(ROOT / "wxfactory_tpu_torch" / "csrc"),
                        help="directory (or path prefix) of sw_element.cuh, sw_operator.cu and sw_run.cu")
    parser.add_argument("--parent", default=None, help="path prefix (or directory) of another version of the three "
                        "files, built and timed as it is in turns with the source's")
    parser.add_argument("--no-ablations", action="store_true", help="build and time the source as it is only")
    parser.add_argument("--no-bitwise", action="store_true", help="skip the bit-for-bit check against the parent")
    parser.add_argument("--variants", default=None, help="comma-separated ablations to build (default: all)")
    parser.add_argument("--groups", default="state,whole,tile,run,tangent,topo",
                        help="timed groups, of: state, whole, tile, run, tangent, topo")
    parser.add_argument("--jv-per-solve", type=int, default=48,
                        help="Jacobian actions a linearisation point for the tangent group's per-solve time")
    args = parser.parse_args(argv)
    groups = set(args.groups.split(","))

    import torch

    if not torch.cuda.is_available():
        print("sw_operator_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    smi = chip_smoke.nvidia_smi()
    t0 = time.perf_counter()
    only = set(args.variants.split(",")) if args.variants else None
    libs, logs, skipped = build_variants(args.source, args.parent, not args.no_ablations, only)
    ptxas = {name: [r for r in chip_smoke.ptxas_summary(log)
                    if r["kernel"].startswith(("sw_operator", "sw_run", "sw_tangent"))]
             for name, log in logs.items()
             if name in ("as_built", "parent", "pert_topo_min_blocks_4") or name in TANGENT_VARIANTS}
    print(json.dumps({"source": args.source, "parent": args.parent, "build_s": time.perf_counter() - t0, "gpu": smi,
                      "built": list(libs), "skipped": skipped, "ptxas": ptxas,
                      "resources": {name: resources(libs[name]) for name in ("as_built", "parent") if name in libs}}),
          flush=True)
    if args.parent is not None and not args.no_bitwise:
        print(json.dumps({"bitwise_against_parent": bitwise(torch, libs), "gpu": smi}), flush=True)
    timing = "the card's time a call: calls queued behind a sleep kernel between two CUDA events, two turns a variant"
    if "tangent" in groups:
        print(json.dumps({"group": "tangent", "gpu": smi, "timing": timing,
                          "results": tangent_group(torch, libs, args.jv_per_solve)}), flush=True)
    if "topo" in groups:
        print(json.dumps({"group": "topography", "gpu": smi, "timing": timing, "results": topo_group(torch, libs)}),
              flush=True)
    if "state" in groups:
        print(json.dumps({"group": "state mode", "gpu": smi, "timing": timing + "; event_ms: median of 20 single "
                          "calls between two CUDA events (the host's launches included)",
                          "results": state_group(torch, libs)}), flush=True)
    for key, group, modes, slow in (("whole", "whole sphere", lambda: whole_sphere_modes(torch), False),
                                    ("tile", "tile", lambda: tile_modes(torch, 32) + tile_modes(torch, 64), False),
                                    ("run", "run", lambda: run_modes(torch), True)):
        if key not in groups:
            continue
        print(json.dumps({"group": group, "gpu": smi, "timing": timing,
                          "results": time_modes(torch, libs, modes(), slow)}), flush=True)
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
