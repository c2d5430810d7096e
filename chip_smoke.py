#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wxfactory_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernel from csrc/ (nvcc, sm_90a) and drives the port's main path:

0. environment: card name and power limit, torch/CUDA/nvcc/sympy versions,
   kernel build time and the compiler's register/spill report;
1. the SW operator kernel against its plain torch version on the card, at
   (nel, s) = (10,3), (64,3), (4,2), (4,8), (64,7), float64 and float32, in
   RHS mode, stage mode with and without x, and with emitted traces
   (tolerances in wxfactory_tpu_torch/kernels/check.py);
2. the same case-6 run (nel=10, s=3, TVD-RK3, dt=30 s, 20 steps, f64) on
   the GPU and on the CPU (plain version): final states agree to 1e-10 of
   each variable's max;
3. the main path at full width: ``python -m wxfactory_tpu_torch`` on
   Williamson case 6, nel=64, s=3, f64, TVD-RK3, dt=10 s, 360 steps, with
   exactly one kernel launch per RK stage, a finite state, mass drift below
   1e-10 and a checkpoint that reads back;
4. time per RHS call of the kernel and of the plain version at nel=64, s=3
   (CUDA events, median), f64 and f32.

Each phase prints one JSON line; then the kernels line, the card's
``nvidia-smi`` name and power limit, and last the result line. Any failure
raises and exits non-zero. Without a CUDA device, or outside a checkout, it
exits non-zero without a result.
"""

import contextlib
import glob
import io
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = [(10, 3), (64, 3), (4, 2), (4, 8), (64, 7)]
WORK = ROOT / "build" / "chip_smoke"

CASE6_INI = """
[General]
equations = shallow_water
[System]
precision = float64
[Test_case]
case_number = 6
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = {nel}
[Grid]
grid_type = cubed_sphere
[Output_options]
save_state_freq = {save}
stat_freq = {save}
output_dir = {out}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str):
    """Registers and spill bytes per kernel instantiation from ``ptxas -v``."""
    rows, current = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"sw_operator_kernelI([df])Li(\d+)E", m.group(1))
            current = {"kernel": f"{'f64' if k.group(1) == 'd' else 'f32'} s={k.group(2)}" if k else m.group(1)}
            rows.append(current)
        elif current is not None:
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                current["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current["registers"] = int(m.group(1))
    return rows


def phase0(torch, smi):
    import sympy

    from wxfactory_tpu_torch.kernels import build

    nvcc = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    build.load_library("sw_operator")
    seconds = time.perf_counter() - t0
    info = build.build_info.get("sw_operator", {"seconds": 0.0, "log": ""})
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "ptxas.log").write_text(info["log"])
    emit({
        "phase": 0, "gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": next((l for l in nvcc if "release" in l), nvcc[-1]), "sympy": sympy.__version__,
        "python": sys.version.split()[0], "build_s": seconds, "nvcc_s": info["seconds"],
        "built_now": bool(info["log"]), "ptxas": ptxas_summary(info["log"]),
    })


def phase1(torch):
    from wxfactory_tpu_torch.kernels.check import compare_sw_operator

    rows = []
    for nel, s in SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_sw_operator(nel, s, dtype, device="cuda")
    emit({"phase": 1, "ok": all(r["ok"] for r in rows), "results": rows})
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    main_path = [r for r in rows if (r["nel"], r["s"], r["dtype"]) == (64, 3, "float64")]
    return max(r["max_abs_err"] for r in main_path)


def phase2(torch):
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    text = CASE6_INI.format(dt=30, t_end=600, nel=10, save=0, out=WORK / "phase2")
    states = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            states[device] = Simulation(Configuration(text), device=device).run().cpu()
    want, got = states["cpu"], states["cuda"]
    scale = want.abs().reshape(3, -1).amax(dim=1).reshape(3, 1, 1, 1, 1)
    err = float(((got - want).abs() / scale).max())
    emit({"phase": 2, "steps": 20, "nel": 10, "s": 3, "dtype": "float64", "err": err, "tol": 1e-10,
          "ok": err <= 1e-10})
    if not err <= 1e-10:
        raise AssertionError(f"GPU and CPU runs differ by {err} of scale")


def phase3(torch):
    from wxfactory_tpu_torch import __main__ as cli
    from wxfactory_tpu_torch.ops import sw_operator as swop
    from wxfactory_tpu_torch.output.state import load_state

    nsteps, nel = 360, 64
    out_dir = WORK / "phase3"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / "case6_nel64_s3.ini"
    ini.write_text(CASE6_INI.format(dt=10, t_end=3600, nel=nel, save=nsteps, out=out_dir))

    log = io.StringIO()
    swop.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = swop.launches
    text = log.getvalue()
    sys.stderr.write(text[-4000:])
    if rc != 0:
        raise AssertionError(f"main path exited with {rc}")
    if launches != 3 * nsteps:
        raise AssertionError(f"{launches} kernel launches in {nsteps} TVD-RK3 steps, expected {3 * nsteps}")
    drifts = [float(v) for v in re.findall(r"normalized error for mass = (\S+)", text)]
    if len(drifts) != 2 or not abs(drifts[-1]) < 1e-10:
        raise AssertionError(f"blockstats mass drift {drifts}")
    energy = [float(v) for v in re.findall(r"normalized error for energy = (\S+)", text)]
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    files = glob.glob(str(out_dir / f"state_vector_*.{nsteps:08d}.npy"))
    if len(files) != 1:
        raise AssertionError(f"checkpoint files {files}")
    state, config, version = load_state(files[0])
    if state.shape != (3, 6, nel, nel, 9) or not bool(torch.isfinite(torch.as_tensor(state)).all()):
        raise AssertionError(f"checkpoint state {state.shape} not finite or misshapen")
    emit({
        "phase": 3, "case": 6, "nel": nel, "s": 3, "points": 6 * nel * nel * 9, "dtype": "float64",
        "integrator": "tvdrk3", "dt": 10.0, "steps": int(run.group(1)), "run_s": float(run.group(2)),
        "steps_per_s": float(run.group(3)), "main_wall_s": wall, "launches": launches,
        "mass_drift": drifts[-1], "energy_drift": energy[-1], "checkpoint": Path(files[0]).name,
        "checkpoint_version": version,
    })
    return launches


def _event_times(torch, fn, n=20):
    """Milliseconds of ``n`` single calls, each between two CUDA events."""
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def phase4(torch, smi):
    from wxfactory_tpu_torch.kernels.check import case6_inputs
    from wxfactory_tpu_torch.ops import sw_operator as swop

    rows = []
    for dtype in (torch.float64, torch.float32):
        con, topology, x, y = case6_inputs(64, 3, dtype, "cuda")
        traces = swop.edge_traces(y, con)
        halo = swop.halo_from_traces(traces, topology)
        kernel = lambda: swop.sw_operator(y, halo, con)
        plain = lambda: swop.sw_operator_plain(y, halo, con)
        stage = lambda: swop.sw_operator(y, halo, con, x=x, a=0.75, b=0.25, cdt=2.5, emit_traces=True)
        glue = lambda: swop.halo_from_traces(traces, topology)
        for fn in (kernel, plain, stage, glue):
            for _ in range(3):
                fn()
        torch.cuda.synchronize()
        k, p = [], []
        for fn, times in ((plain, p), (kernel, k), (kernel, k), (plain, p)):
            times.extend(_event_times(torch, fn))
        rows.append({
            "nel": 64, "s": 3, "dtype": str(dtype).replace("torch.", ""),
            "kernel_rhs_ms": statistics.median(k), "plain_rhs_ms": statistics.median(p),
            "kernel_stage_traces_ms": statistics.median(_event_times(torch, stage)),
            "halo_glue_ms": statistics.median(_event_times(torch, glue)),
            "calls_each": len(k),
        })
    emit({"phase": 4, "gpu": smi, "timing": "CUDA events, median per call", "results": rows})
    return rows[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "wxfactory_tpu_torch" / "csrc" / "sw_operator.cu").is_file():
        print("chip_smoke: run from the root of a checkout (wxfactory_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    smi = nvidia_smi()
    phase0(torch, smi)
    max_abs_err = phase1(torch)
    phase2(torch)
    launches = phase3(torch)
    timing = phase4(torch, smi)
    emit({"kernels": [{
        "name": "sw_operator", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/sw_operator.cu",
        "replaces": "wxfactory_tpu/ops/pallas_sw_gen.py:632", "launches": launches,
        "max_abs_err": max_abs_err, "ms": timing["kernel_rhs_ms"], "plain_ms": timing["plain_rhs_ms"],
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
