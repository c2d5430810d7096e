"""What bounds the 3D Euler tangent kernels on the card: their compiler
report and their time as they are, with the interface (face) loop skipped,
and with the transcendentals (log, exp, log1p, expm1) replaced by the
identity.

    python tools/tangent_ablation.py [--source path/to/euler3d_operator.cu] [--shapes 20,20,3:12,3,2]
                                     [--blocks 1:1,2:4] [--parent path/to/earlier/euler3d_operator.cu]

The ablations (for the apply also: its interior faces without the
neighbour's reads, its interface coefficient rows all read from one
address; with ``--blocks``, the apply compiled for other occupancy targets)
are throwaway copies of the source (text substitutions, not switches in
the kernel), each built with nvcc (sm_90a, ``-Xptxas -v``) into
build/ablation/ and called through ctypes on the current CUDA stream.
``--parent`` builds another version of the source as it is, times it in
turns with the others (``git show REV:wxfactory_tpu_torch/csrc/
euler3d_operator.cu > build/parent.cu`` on a machine with the history) and
holds the source's prep and apply outputs against the parent's on the same
inputs bit for bit (``torch.equal``; the line ``bitwise_against_parent``).
The script knows the two interfaces the source has had: the one-call
tangent kernel (C entry ``euler3d_tangent_launch``) and the prep + apply
pair (``euler3d_tangent_prep_launch``, ``euler3d_tangent_apply_launch``);
it times every one a built library exports, in float64 (absolute form) and
float32 (perturbation form) and, as built, also float32 absolute and
float64 perturbation. Inputs are those of ``kernels/check.py``
(``euler3d_tangent_inputs``, ``euler3d_pert_inputs``). Time: CUDA events
around 20 back-to-back calls, the mean a call, variants in turns (each
once, then in reverse order). Prints one JSON line with the registers and
spills of every kernel (and, for the prep + apply source, what the runtime
reports of them), one per shape, and the card's name and power limit. An
ablated kernel computes garbage: only its time is read.
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

OUT = ROOT / "build" / "ablation"
TRANSCENDENTALS = ["logf", "expf", "log1pf", "expm1f", "log", "exp", "log1p", "expm1"]


def _identity_transcendentals(src: str) -> str:
    for fn in TRANSCENDENTALS:
        src, n = re.subn(r"\{ return %s\(v\); \}" % fn, "{ return v; }", src)
        if n != 1:
            raise ValueError(f"transcendental helper {fn} not found once in the source")
    return src


def _no_face_loop(src: str) -> str:
    # The one-call kernel's (and the operator kernel's) face loop, and the
    # face-item loops of the prep and apply kernels.
    src, n_old = re.subn(r"fi < NF; fi \+= S3", "fi < 0; fi += S3", src)
    src, n_new = re.subn(r"it < n_items; it \+= blockDim\.x", "it < 0; it += blockDim.x", src)
    if n_old + n_new == 0:
        raise ValueError("no face loop found in the source")
    return src


def _no_neighbour_reads(src: str) -> str:
    # The apply's interior faces whose neighbour is outside the block take
    # the halo or mirror branch: no read of the neighbour's v and node
    # coefficients from device memory.
    src, n = re.subn(r"if \(!boundary\) \{([^\n]*\n\s+const T\* src = vd)", r"if (!boundary && false) {\1", src)
    if n != 1:
        raise ValueError("the apply's neighbour branch not found once in the source")
    return src


def _no_coefficient_reads(src: str) -> str:
    # Every interface coefficient row of the apply read from row 0's
    # address (one cache line instead of 22 rows).
    src, n = re.subn(r"const long long rs = lay\.rows\(d\);(\s+const int own_side)", r"const long long rs = 0;\1", src)
    if n != 1:
        raise ValueError("the apply's interface coefficient reads not found once in the source")
    return src


def _apply_blocks(f64: int, f32: int):
    """The apply compiled for ``f64`` / ``f32`` resident blocks an SM (its
    register cap) instead of the source's ``ApplyBlocks``."""
    def edit(src: str) -> str:
        src, n = re.subn(r"sizeof\(T\) == 8 \? \d+ : \d+;", f"sizeof(T) == 8 ? {f64} : {f32};", src)
        if n != 1:
            raise ValueError("ApplyBlocks not found once in the source")
        return src
    return edit


VARIANTS = {
    "as_built": lambda s: s,
    "no_face_loop": _no_face_loop,
    "identity_transcendentals": _identity_transcendentals,
}
# Ablations that only the prep + apply source has.
APPLY_VARIANTS = {"no_neighbour_reads": _no_neighbour_reads, "no_coefficient_reads": _no_coefficient_reads}


def build_variants(source: Path, blocks=(), parent=None):
    from wxfactory_tpu_torch.kernels import build

    OUT.mkdir(parents=True, exist_ok=True)
    text = source.read_text()
    variants = dict(VARIANTS)
    if "euler3d_tangent_apply_kernel" in text:
        variants.update(APPLY_VARIANTS)
    variants.update({f"apply_blocks_{a}_{b}": _apply_blocks(a, b) for a, b in blocks})
    sources = {name: edit(text) for name, edit in variants.items()}
    if parent is not None:
        sources["parent"] = Path(parent).read_text()
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
        libs[name] = ctypes.CDLL(str(so))
    return libs, logs


P, I = ctypes.c_void_p, ctypes.c_int
ENTRIES = {
    # is_f64, s, nel_h, nel_v, q, v, halo_q, halo_v, ops1d, fields, tch, itf_x, itf_y, itf_z, q0, halo0, out, stream
    "euler3d_tangent_launch": [I, I, I, I] + [P] * 13 + [P],
    # is_f64, s, nel_h, nel_v, q, halo_q, ops1d, fields, itf_x, itf_y, itf_z, q0, halo0, coef, stream
    "euler3d_tangent_prep_launch": [I, I, I, I] + [P] * 10 + [P],
    # is_f64, s, nel_h, nel_v, v, halo_v, ops1d, fields, tch, itf_x, itf_y, itf_z, coef, out, stream
    "euler3d_tangent_apply_launch": [I, I, I, I] + [P] * 10 + [P],
}


def _entry(lib, name):
    try:
        fn = getattr(lib, name)
    except AttributeError:
        return None
    fn.restype = I
    fn.argtypes = ENTRIES[name]
    return fn


def calls(torch, lib, con, inputs, pert):
    """{kernel: zero-argument launcher} of the tangent entries ``lib``
    exports, on ``inputs`` (q, v, halo_q, halo_v: the state or the
    perturbation and the direction with their halos)."""
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    q, v, halo_q, halo_v = inputs
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    f64 = 1 if q.dtype == torch.float64 else 0
    head = (f64, con.s, con.nel_h, con.nel_v)
    q0 = pert.q0 if pert is not None else None
    halo0 = pert.halo0 if pert is not None else None
    out = torch.empty_like(q)

    def checked(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    fns = {}
    one = _entry(lib, "euler3d_tangent_launch")
    if one is not None:
        fns["tangent"] = lambda: checked(one(*head, ptr(q), ptr(v), ptr(halo_q), ptr(halo_v), ptr(con.ops1d),
                                             ptr(con.fields), ptr(con.tch), ptr(con.itf_x), ptr(con.itf_y),
                                             ptr(con.itf_z), ptr(q0), ptr(halo0), ptr(out), stream()))
        fns["tangent"].result = out
    prep, apply = _entry(lib, "euler3d_tangent_prep_launch"), _entry(lib, "euler3d_tangent_apply_launch")
    if prep is not None and apply is not None:
        coef = torch.empty(e3op.tangent_layout(con)["size"], dtype=q.dtype, device=q.device)
        fns["prep"] = lambda: checked(prep(*head, ptr(q), ptr(halo_q), ptr(con.ops1d), ptr(con.fields),
                                           ptr(con.itf_x), ptr(con.itf_y), ptr(con.itf_z), ptr(q0), ptr(halo0),
                                           ptr(coef), stream()))
        fns["apply"] = lambda: checked(apply(*head, ptr(v), ptr(halo_v), ptr(con.ops1d), ptr(con.fields),
                                             ptr(con.tch), ptr(con.itf_x), ptr(con.itf_y), ptr(con.itf_z), ptr(coef),
                                             ptr(out), stream()))
        fns["prep"].result, fns["apply"].result = coef, out  # what the last calls wrote
    if not fns:
        raise RuntimeError("the library exports no tangent entry this script knows")
    return fns


def resources(lib):
    """Registers, spill bytes, dynamic shared memory and resident blocks an
    SM of the prep and apply kernels at s = 2 and 3, as the runtime reports
    them (empty for a source without the entry)."""
    try:
        fn = lib.euler3d_tangent_resources
    except AttributeError:
        return []
    fn.restype, fn.argtypes = I, [I, I, I, P]
    rows = []
    for f64 in (1, 0):
        for s in (2, 3):
            for kernel, name in enumerate(("prep", "prep_pert", "apply")):
                info = (ctypes.c_int * 5)()
                if fn(f64, s, kernel, ctypes.cast(info, P)) != 0:
                    raise RuntimeError(f"euler3d_tangent_resources failed for {name} s={s}")
                rows.append({"kernel": name, "dtype": "float64" if f64 else "float32", "s": s,
                             **dict(zip(("registers", "local_bytes", "smem_bytes", "blocks_per_sm", "threads"), info))})
    return rows


def mean_ms(torch, fn, n=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--source", default=str(ROOT / "wxfactory_tpu_torch" / "csrc" / "euler3d_operator.cu"))
    parser.add_argument("--shapes", default="20,20,3:12,3,2", help="nel_h,nel_v,s shapes separated by ':'")
    parser.add_argument("--blocks", default="", help="extra variants: the apply compiled for f64:f32 resident "
                        "blocks an SM, pairs separated by ','")
    parser.add_argument("--parent", default=None, help="another source (an earlier version of the file) built and "
                        "timed as it is in turns with the others")
    args = parser.parse_args(argv)
    blocks = [tuple(int(x) for x in pair.split(":")) for pair in args.blocks.split(",") if pair]

    import torch

    if not torch.cuda.is_available():
        print("tangent_ablation: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from wxfactory_tpu_torch.kernels.check import euler3d_pert_inputs, euler3d_tangent_inputs, pert_halos, tangent_halos

    smi = chip_smoke.nvidia_smi()
    t0 = time.perf_counter()
    libs, logs = build_variants(Path(args.source), blocks, args.parent)
    shown = [name for name in libs if name.startswith(("as_", "apply_")) or name == "parent"]
    print(json.dumps({"source": args.source, "build_s": time.perf_counter() - t0, "gpu": smi,
                      "ptxas": {name: chip_smoke.ptxas_summary(logs[name]) for name in shown},
                      "resources": {name: resources(libs[name]) for name in shown}}), flush=True)
    checked = []
    for shape in args.shapes.split(":"):
        nel_h, nel_v, s = (int(x) for x in shape.split(","))
        rows = []
        for dtype, pert_form in ((torch.float64, False), (torch.float32, True), (torch.float32, False),
                                 (torch.float64, True)):
            if pert_form:
                con, topology, pert, dq, v = euler3d_pert_inputs(nel_h, nel_v, s, dtype, "cuda")
                inputs = (dq, v) + pert_halos(dq, v, pert, con, topology)
            else:
                con, topology, q, v = euler3d_tangent_inputs(nel_h, nel_v, s, dtype, "cuda")
                pert, inputs = None, (q, v) + tangent_halos(q, v, con, topology)
            # Ablations only for the two forms of rows 8b and 8c.
            ablate = (dtype == torch.float64) != pert_form
            names = list(libs) if ablate else ["as_built"] + (["parent"] if "parent" in libs else [])
            launchers = {name: calls(torch, libs[name], con, inputs, pert) for name in names}
            times = {name: {k: [] for k in launchers[name]} for name in names}
            for name in names + names[::-1]:
                for kernel, fn in launchers[name].items():
                    times[name][kernel].append(mean_ms(torch, fn))
            row = {"dtype": str(dtype).replace("torch.", ""), "form": "perturbation" if pert_form else "absolute",
                   "ms": {name: {k: sorted(t) for k, t in kt.items()} for name, kt in times.items()}}
            if "parent" in launchers:  # each one's last prep and apply, on its own buffer, bit for bit
                torch.cuda.synchronize()
                row["identical_to_parent"] = {k: bool(torch.equal(fn.result, launchers["parent"][k].result))
                                              for k, fn in launchers["as_built"].items() if k in launchers["parent"]}
                for k, same in row["identical_to_parent"].items():
                    checked.append((f"{shape} {row['dtype']} {row['form']} {k}", same))
            rows.append(row)
            del launchers, inputs
            torch.cuda.empty_cache()
        print(json.dumps({"nel_h": nel_h, "nel_v": nel_v, "s": s, "gpu": smi,
                          "timing": "CUDA events around 20 calls, mean a call, two turns a variant",
                          "results": rows}), flush=True)
    if args.parent is not None:
        print(json.dumps({"bitwise_against_parent": {"cases": len(checked), "identical": sum(c for _, c in checked),
                                                     "differ": [k for k, c in checked if not c]}, "gpu": smi}),
              flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
