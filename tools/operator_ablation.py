"""What bounds the 3D Euler operator on the card (the RHS, stage and
perturbation modes of csrc/euler3d_operator.cu and its tile launch): its
compiler and runtime report and its time as it is, with its interface work
skipped (the one-kernel operator's face loop, or the interface pass not
launched), with no neighbour's trace re-extrapolated from device memory
(the element's own trace, or the halo entry, read in its place), and with
the transcendentals (log, exp, log1p, expm1) replaced by the identity.

    python tools/operator_ablation.py [--source path/to/euler3d_operator.cu] [--shapes 20,20,3:12,3,2]
                                      [--parent path/to/earlier/euler3d_operator.cu] [--tiles 10,20]
                                      [--no-ablations] [--blocks ItfBlocks:2:2:4:4,VolBlocks:3:2:3:3]

On the machine with the card, from the root of a copy of the checkout; a
copy without the git history needs the parent's source written first, on a
machine that has it, into the git-ignored build/ that the copy carries:

    git show 3eae058:wxfactory_tpu_torch/csrc/euler3d_operator.cu > build/parent.cu
    python tools/operator_ablation.py --parent build/parent.cu    # on the card

The ablations are throwaway copies of the source (text substitutions, not
switches in the kernel), each built with nvcc (sm_90a, ``-Xptxas -v``) into
build/operator_ablation/ and called through ctypes on the current CUDA
stream; a substitution that does not apply to a source leaves that variant
out for it (the line says which were built). ``--blocks`` adds the source
compiled for other resident blocks an SM (the register caps ``ItfBlocks``
and ``VolBlocks``). ``--parent`` builds another version of the source as it
is and times it in turns with the source's.
Modes at each shape: float64 absolute RHS, float64 stage + x + traces,
float32 and float64 perturbation stage + x + delta traces (ablated), and,
as built, float32 absolute RHS and stage and both perturbation RHS;
``--tiles`` adds the tile launch (stage + x + traces, 20 levels, s=3, the
tile nt of a sphere of nel_h = 20) in float64 and float32 perturbation
form. Inputs are those of ``kernels/check.py`` (``euler3d_inputs``,
``euler3d_pert_inputs``, ``euler3d_tile_inputs``). Time: the card's time a
call, 20 calls queued behind a sleep kernel between two CUDA events
(``chip_smoke._device_ms``), variants in turns (each once, then in reverse
order). Prints one JSON line with the registers and spills (``ptxas -v``)
and the runtime's registers, shared memory a block and resident blocks an
SM of every operator instantiation at s = 2..6, then one line per shape,
and the card's name and power limit. An ablated kernel computes garbage:
only its time is read.
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

from tangent_ablation import _identity_transcendentals  # noqa: E402

OUT = ROOT / "build" / "operator_ablation"


def _no_face_loop(src: str) -> str:
    # The operator's interface work: the one-kernel operator's per-face
    # loop, or the interface pass of the two-kernel operator (not launched).
    src, n_old = re.subn(r"fi < NF; fi \+= S3", "fi < 0; fi += S3", src)
    src, n_new = re.subn(r"(\n\s*)(euler3d_interface_kernel<T, S, PERT(, false)?><<<)", r"\1if (false) \2", src)
    if n_old + n_new == 0:
        raise ValueError("no operator face loop found in the source")
    return src


def _no_neighbour_reads(src: str) -> str:
    # The neighbour's trace re-extrapolated from device memory replaced by
    # the element's own trace (absolute and perturbation form).
    n = 0
    src, k = re.subn(r"nb_trace<T, S>\(q, nq, nb_elem, base, stride, ncoef, nb\);",
                     "for (int v = 0; v < 5; ++v) nb[v] = own[v];", src)
    n += k
    src, k = re.subn(r"nb_trace<T, S>\(q0, nq, nb_elem, base, stride, ncoef, nb0\);\s*"
                     r"nb_delta_trace<T, S>\(q, q0, nq, nb_elem, base, stride, ncoef, nb0, nb\);",
                     "for (int v = 0; v < 5; ++v) { nb0[v] = own0[v]; nb[v] = own[v]; }", src)
    n += k
    # The interface pass: its one call site of the device-memory trace
    # (the halo entry read instead).
    src, k = re.subn(r"if \(src == kDevice\) \{", "if (false) {", src)
    n += k
    if n == 0:
        raise ValueError("no neighbour re-extrapolation found in the source")
    return src


def _op_blocks(trait: str, f64: int, f64_pert: int, f32: int, f32_pert: int):
    """The operator's kernel whose occupancy trait is ``trait`` (``ItfBlocks``,
    ``VolBlocks``) compiled for other resident blocks an SM (its register
    cap) than the source's."""
    def edit(src: str) -> str:
        src, n = re.subn(r"(struct %s \{\n  static constexpr int value = )sizeof\(T\) == 8 \? \(PERT \? \d+ : \d+\) : "
                         r"\(PERT \? \d+ : \d+\);" % trait,
                         r"\g<1>" + f"sizeof(T) == 8 ? (PERT ? {f64_pert} : {f64}) : (PERT ? {f32_pert} : {f32});", src)
        if n != 1:
            raise ValueError(f"{trait} not found once in the source")
        return src
    return edit


VARIANTS = {
    "as_built": lambda s: s,
    "no_face_loop": _no_face_loop,
    "no_neighbour_reads": _no_neighbour_reads,
    "identity_transcendentals": _identity_transcendentals,
}

# What the runtime reports of an operator instantiation, appended to a
# source that has no such entry (the operator kernel of 3eae058).
PARENT_RESOURCES = r"""
namespace {
template <typename T, int S, bool PERT>
cudaError_t ablation_resources(int* info) {
  using Sh = Shape<T, S, PERT>;
  return kernel_resources(euler3d_operator_kernel<T, S, PERT>, Sh::EB * Sh::S3,
                          sizeof(T) * (Sh::N_OPS + (size_t)Sh::EB * Sh::PER_ELEM), info);
}
template <typename T, bool PERT>
cudaError_t ablation_dispatch(int s, int* info) {
  switch (s) {
    case 2: return ablation_resources<T, 2, PERT>(info);
    case 3: return ablation_resources<T, 3, PERT>(info);
    case 4: return ablation_resources<T, 4, PERT>(info);
    case 5: return ablation_resources<T, 5, PERT>(info);
    case 6: return ablation_resources<T, 6, PERT>(info);
    default: return cudaErrorInvalidValue;
  }
}
}  // namespace
extern "C" int euler3d_operator_resources(int is_f64, int s, int pert, int kernel, int* info) {
  (void)kernel;  // one kernel
  if (is_f64) return (int)(pert ? ablation_dispatch<double, true>(s, info) : ablation_dispatch<double, false>(s, info));
  return (int)(pert ? ablation_dispatch<float, true>(s, info) : ablation_dispatch<float, false>(s, info));
}
"""


def _with_resources(src: str) -> str:
    return src if "euler3d_operator_resources" in src else src + PARENT_RESOURCES


def build_variants(source: Path, parent=None, ablations: bool = True, blocks=()):
    """{name: ctypes library} of the source's variants (and the parent's),
    all nvcc processes started together; {name: nvcc log}; and {name: why
    left out} of the variants whose substitution does not apply."""
    from wxfactory_tpu_torch.kernels import build

    OUT.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    sources, skipped = {}, {}
    variants = dict(VARIANTS) if ablations else {"as_built": VARIANTS["as_built"]}
    variants.update({"blocks_" + "_".join(map(str, b)): _op_blocks(*b) for b in blocks})
    for name, edit in variants.items():
        try:
            sources[name] = _with_resources(edit(text))
        except ValueError as err:
            skipped[name] = str(err)
    if parent is not None:
        sources["parent"] = _with_resources(Path(parent).read_text())
    procs = {}
    for name, src in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(src)
        so = OUT / f"lib{name}.so"
        cmd = [build.nvcc_path(), *build.ARCH_FLAGS, *build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs, logs = {}, {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name}:\n{log}")
        logs[name] = log
        lib = ctypes.CDLL(str(so))
        for fn, (restype, argtypes) in build.SIGNATURES["euler3d_operator"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        lib.euler3d_operator_resources.restype = ctypes.c_int
        lib.euler3d_operator_resources.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.kernels = ({0: "interface", 1: "volume"} if "euler3d_interface_kernel" in sources[name]
                       else {1: "operator"})
        libs[name] = lib
    return libs, logs, skipped


def resources(lib):
    """Registers, spill bytes, dynamic shared memory, resident blocks an SM
    and threads a block of every instantiation of the operator's kernels,
    as the runtime reports them."""
    rows = []
    for f64 in (1, 0):
        for pert in (0, 1):
            for s in range(2, 7):
                for kernel, name in lib.kernels.items():
                    info = (ctypes.c_int * 5)()
                    rc = lib.euler3d_operator_resources(f64, s, pert, kernel, ctypes.cast(info, ctypes.c_void_p))
                    if rc != 0:
                        raise RuntimeError(f"euler3d_operator_resources failed: CUDA error {rc}")
                    vals = dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads"), info))
                    rows.append({"kernel": name, "dtype": "float64" if f64 else "float32",
                                 "form": "perturbation" if pert else "absolute", "s": s, **vals,
                                 "threads_per_sm": vals["blocks_per_sm"] * vals["threads"]})
    return rows


def launcher(torch, lib, entry, con, q, halo, x=None, a=0.0, b=1.0, cdt=None, traces=False, pert=None):
    """A zero-argument launcher of one call of ``entry`` (the operator or
    the tile launch) of ``lib`` on these inputs."""
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    out = torch.empty_like(q)
    tr = torch.empty(con.traces_shape, dtype=q.dtype, device=q.device) if traces else None
    base = pert.tensors if pert is not None else {}
    fn = getattr(lib, entry)
    use_x = cdt is not None and a != 0.0

    def call():
        rc = fn(1 if q.dtype == torch.float64 else 0, con.s, con.nel_h, con.nel_v, ptr(q), ptr(halo), ptr(con.ops1d),
                ptr(con.fields), ptr(con.tch), ptr(con.itf_x), ptr(con.itf_y), ptr(con.itf_z),
                ptr(x if use_x else None), None, ptr(base.get("q0")), ptr(base.get("halo0")), ptr(base.get("rhs0")),
                ptr(base.get("traces0")), ptr(out), ptr(tr), float(a), float(b),
                float(cdt if cdt is not None else 0.0), 1 if cdt is not None else 0,
                ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"{entry} failed: CUDA error {rc}")

    call.outputs = (out,) if tr is None else (out, tr)  # what the last call wrote
    return call


def whole_sphere_modes(torch, nel_h, nel_v, s):
    """[(mode, ablate, (con, q, halo, kwargs))] of the operator launch."""
    from wxfactory_tpu_torch.kernels.check import E3_DT, euler3d_inputs, euler3d_pert_inputs
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    modes = []
    for dtype in (torch.float64, torch.float32):
        name = "f64" if dtype == torch.float64 else "f32"
        con, topology, x, y = euler3d_inputs(nel_h, nel_v, s, dtype, "cuda")
        halo = e3op.halo_from_traces(e3op.edge_traces(y, con), topology)
        stage = dict(x=x, a=0.75, b=0.25, cdt=0.25 * E3_DT, traces=True)
        modes.append((f"{name}_rhs", dtype == torch.float64, (con, y, halo, {})))
        modes.append((f"{name}_stage_x_traces", dtype == torch.float64, (con, y, halo, stage)))
        con, topology, pert, dq, _ = euler3d_pert_inputs(nel_h, nel_v, s, dtype, "cuda")
        dx = dq.flip(0).contiguous()
        halo = e3op.halo_from_traces(e3op.edge_traces_delta(dq, pert, con), topology)
        modes.append((f"{name}_pert_rhs", False, (con, dq, halo, dict(pert=pert))))
        modes.append((f"{name}_pert_stage_x_traces", True, (con, dq, halo, dict(stage, x=dx, pert=pert))))
    return modes


def tile_modes(torch, nt, nel_v=20, s=3, nel_h=20):
    """[(mode, ablate, (con, q, halo, kwargs))] of the tile launch at the
    checked tile of a sphere of nel_h (N = nel_h / nt)."""
    from wxfactory_tpu_torch.kernels import check

    n = nel_h // nt
    con64, pert64, inputs64, _ = check.euler3d_tile_inputs(nt, nel_v, s, 31, n, "cuda")
    modes = []
    for dtype, pert in ((torch.float64, False), (torch.float32, True)):
        con, base = check.cast_constants(con64, dtype), check.cast_constants(pert64, dtype)
        inp = {k: v.to(dtype) for k, v in inputs64.items()}
        y, h, x = (inp["dq"], inp["halo_dq"], inp["dx"]) if pert else (inp["y"], inp["halo_y"], inp["x"])
        kw = dict(x=x, a=0.75, b=0.25, cdt=0.25 * check.E3_DT, traces=True, pert=base if pert else None)
        tag = "f32_pert" if pert else "f64"
        modes.append((f"tile_nt{nt}_{tag}_stage_x_traces", False, (con, y, h, kw)))
    return modes


def time_modes(torch, libs, modes, entry):
    from chip_smoke import _device_ms

    rows = []
    for mode, ablate, (con, q, halo, kw) in modes:
        names = [n for n in libs if ablate or n in ("as_built", "parent") or n.startswith("blocks_")]
        calls = {n: launcher(torch, libs[n], entry, con, q, halo, **kw) for n in names}
        for fn in calls.values():
            fn()
        torch.cuda.synchronize()
        times = {n: [] for n in names}
        for n in names + names[::-1]:
            times[n].append(_device_ms(torch, calls[n], 20))
        row = {"mode": mode, "ms": {n: sorted(t) for n, t in times.items()}}
        if "parent" in calls:  # the last calls of each on the same inputs, bit for bit
            torch.cuda.synchronize()
            row["identical_to_parent"] = all(torch.equal(a, b) for a, b in zip(calls["as_built"].outputs,
                                                                                calls["parent"].outputs))
        rows.append(row)
        del calls
    return rows


def bitwise_summary(rows) -> dict:
    """How many calls of the source equal the parent's bit for bit."""
    checked = [r for r in rows if "identical_to_parent" in r]
    return {"cases": len(checked), "identical": sum(r["identical_to_parent"] for r in checked),
            "differ": [r["mode"] for r in checked if not r["identical_to_parent"]]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", default=str(ROOT / "wxfactory_tpu_torch" / "csrc" / "euler3d_operator.cu"))
    parser.add_argument("--shapes", default="20,20,3:12,3,2", help="nel_h,nel_v,s shapes separated by ':'")
    parser.add_argument("--parent", default=None, help="another source (an earlier version of the file) built and "
                        "timed as it is in turns with the source's")
    parser.add_argument("--tiles", default="", help="tile widths nt (of a 20x20x20, s=3 sphere) to time the tile "
                        "launch at, separated by ','")
    parser.add_argument("--no-ablations", action="store_true", help="build and time the source as it is only")
    parser.add_argument("--blocks", default="", help="extra variants: the kernel of occupancy trait TRAIT compiled "
                        "for f64:f64_pert:f32:f32_pert resident blocks an SM, TRAIT:a:b:c:d separated by ','")
    args = parser.parse_args(argv)
    blocks = [(quad.split(":")[0], *(int(x) for x in quad.split(":")[1:])) for quad in args.blocks.split(",") if quad]

    import torch

    if not torch.cuda.is_available():
        print("operator_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke

    smi = chip_smoke.nvidia_smi()
    t0 = time.perf_counter()
    libs, logs, skipped = build_variants(Path(args.source), args.parent, not args.no_ablations, blocks)
    ptxas = {name: [r for r in chip_smoke.ptxas_summary(log) if r["kernel"].startswith(("euler3d_operator",
                                                                                      "euler3d_interface",
                                                                                      "euler3d_volume"))]
             for name, log in logs.items() if name in ("as_built", "parent") or name.startswith("blocks_")}
    print(json.dumps({"source": args.source, "build_s": time.perf_counter() - t0, "gpu": smi, "built": list(libs),
                      "skipped": skipped, "ptxas": ptxas,
                      "resources": {name: resources(lib) for name, lib in libs.items()
                                    if name in ("as_built", "parent") or name.startswith("blocks_")}}), flush=True)
    everything = []
    for shape in args.shapes.split(":"):
        nel_h, nel_v, s = (int(x) for x in shape.split(","))
        rows = time_modes(torch, libs, whole_sphere_modes(torch, nel_h, nel_v, s), "euler3d_operator_launch")
        everything += [dict(r, mode=f"{shape} {r['mode']}") for r in rows]
        print(json.dumps({"nel_h": nel_h, "nel_v": nel_v, "s": s, "gpu": smi,
                          "timing": "the card's time a call: 20 calls queued behind a sleep kernel between two CUDA "
                                    "events, two turns a variant", "results": rows}), flush=True)
        torch.cuda.empty_cache()
    for nt in (int(x) for x in args.tiles.split(",") if x):
        rows = time_modes(torch, libs, tile_modes(torch, nt), "euler3d_tile_launch")
        everything += rows
        print(json.dumps({"tile_nt": nt, "nel_v": 20, "s": 3, "gpu": smi, "results": rows}), flush=True)
    if args.parent is not None:
        print(json.dumps({"bitwise_against_parent": bitwise_summary(everything), "gpu": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
