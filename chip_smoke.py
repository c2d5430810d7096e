#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wxfactory_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It builds the
CUDA kernels from csrc/ (one nvcc per source, sm_90a, all started together)
and drives the port's two main paths, shallow water and 3D Euler:

0. environment: card name and power limit, torch/CUDA/nvcc/sympy versions,
   kernel build time and the compiler's register/spill report;
1. the SW operator kernel against its plain torch version on the card, at
   (nel, s) = (10,3), (64,3), (4,2), (4,8), (64,7), float64 and float32, in
   RHS mode, stage mode with and without x, and with emitted traces
   (tolerances in wxfactory_tpu_torch/kernels/check.py);
2. the same case-6 run (nel=10, s=3, TVD-RK3, dt=30 s, 20 steps, f64) on
   the GPU and on the CPU (plain version): final states agree to 1e-10 of
   each variable's max;
3. the SW main path at full width: ``python -m wxfactory_tpu_torch`` on
   Williamson case 6, nel=64, s=3, f64, TVD-RK3, dt=10 s, 360 steps, with
   exactly one kernel launch per RK stage, a finite state, mass drift below
   1e-10 and a checkpoint that reads back;
4. time per RHS call of the SW kernel and of the plain version at nel=64,
   s=3 (CUDA events, median), f64 and f32;
5. the 3D Euler operator kernel against its plain version on the card, at
   (nel_h, nel_v, s) = (3,2,2), (12,3,2), (4,2,3), (20,20,3), (4,4,4),
   (3,2,5), (2,2,6) on DCMIP 31 and (4,2,3) on the rotating planet of case
   77, float64 and float32, in RHS mode, stage mode with and without x, with
   emitted traces, and (float32) with the well-balanced offset;
6. the same dcmip31 run (3x2x2, s=2, TVD-RK3, dt=2 s, 10 steps, f64) on the
   GPU and on the CPU: final states agree to 1e-10 of each variable's max;
7. the 3D main path: ``python -m wxfactory_tpu_torch`` on dcmip31 at
   nel_h = nel_v = 20, s=3 (1,296,000 points), f64, TVD-RK3, dt=0.1 s, 200
   steps (20 simulated seconds), then the canonical 12x12x3, s=2, dt=0.5 s,
   150 steps; each with exactly one kernel launch per RK stage, a finite
   state, mass drift below 1e-11 and checkpoints that read back;
8. time per call at 20x20x3, s=3 of the 3D kernel (RHS; stage + x +
   traces), its plain version and the halo glue (CUDA events, median), f64
   and f32, beside the call's memory/compute bound;
9. the 3D kernel's tangent mode (the Jacobian action J(q).v) against its
   plain version (torch.func.jvp of the plain operator) on the card at every
   shape of phase 5, f64 within 1e-12 of the plain J.v's max per variable,
   f32 within 5e-5 of the f64 plain J.v's (rows in build/chip_smoke/
   phase9.json);
10. the same dcmip31 EPI2+KIOPS run (4x2x2, s=2, dt=30 s, 2 steps, f64) on
    the GPU and on the CPU: identical Krylov statistics at every step, final
    states within 1e-10 of each variable's max;
11. the EPI2 main path: ``python -m wxfactory_tpu_torch`` on dcmip31 with
    epi2, kiops, tolerance 1e-7, dt=30 s, at the canonical 12x12x3, s=2 for
    10 steps, then at 20x20x3, s=3 for 3 steps; each with one RHS-kernel
    launch a step, one tangent-kernel launch per Jacobian action the
    integrator asked for, no plain tangent call, a finite state, mass drift
    below the KIOPS tolerance 1e-7 at every step (the first step's update
    cancels ~12 orders of magnitude at the balanced initial state and moves
    mass by a few 1e-8, as in the JAX package; tools/epi2_mass_drift.py)
    and checkpoints (one a step) that read back; it reports steps/s, setup
    time, the Krylov statistics and (torch.profiler, on a second build of
    the same configuration) the tangent kernel's share of device time;
12. time per call at 20x20x3, s=3 (CUDA events, median), f64 and f32, of the
    tangent kernel, its plain version, the tangent glue and the RHS kernel,
    beside the tangent call's memory/compute bound;
13. the kernel's perturbation mode (RHS: rhs0 + delta; tangent: J(q0 +
    dq).v) against its plain version on the card at every shape of phase 5,
    f64 within 1e-12, f32 within 5e-5 of the f64 plain output or twice the
    f32 plain output's distance (rows in build/chip_smoke/phase13.json);
14. the same dcmip31 EPI2 runs with kiops_jit (dt=30 s, 2 steps) on the GPU
    and the CPU: float64 at 4x2x2, s=2 with identical Krylov statistics and
    states within 1e-10, mixed precision (the float32 perturbation
    companion) at 4x2x4, s=4 within 2e-5 (and its distance at 4x2x2
    reported);
15. the mixed-precision EPI2 main path: ``python -m wxfactory_tpu_torch``
    with epi2, kiops_jit, mixed_precision_krylov = 1, device_step_chunk = 5,
    at the canonical 12x12x3, s=2 (20 steps) and at 20x20x3, s=3 (5 steps),
    then both with mixed_precision_krylov = 0 (the float64 kiops_jit step;
    10 and 5 steps);
    each with one perturbation-tangent (mixed) or tangent (float64) launch
    per Jacobian action, one RHS launch a step (and, mixed, the float64
    base RHS at setup), no plain call, host syncs a step at most the Krylov
    controls + 2, a finite state, mass drift below the KIOPS tolerance at
    every checkpoint (every chunk's end) and checkpoints that read back; it
    reports steps/s, setup time, the Krylov statistics, the syncs and (on a
    second build) the device's busy share and its split by kernel class;
16. time per call at 20x20x3, s=3 (CUDA events, median), f64 and f32, of the
    perturbation tangent kernel, its plain version, its glue and the
    perturbation RHS kernel beside their bounds, and of one Arnoldi
    iteration of each kiops_jit variant (a 64-iteration cycle);
17. the SW operator's perturbation mode (RHS rhs0 + delta, stages of deltas,
    emitted delta traces), the halo kernel and the edge-trace kernel against
    their plain versions at the shapes of phase 1 and (8,4), (32,4), (64,4),
    f64 and f32 (rows in build/chip_smoke/phase17.json), and the whole-run
    kernel at (32,4) and (64,4), 1-3 steps, absolute and perturbation form,
    against the plain loop and, asked bit for bit, the chained per-stage
    kernels;
18. GPU against CPU: 10 float64 TVD-RK3 steps of the SW perturbation form
    at nel=10, s=3, and packed_run at (32,4) for 2 steps (absolute and
    perturbation), within 1e-10 of each variable's max;
19. the SW production operating point as bench.py:449-495 drives it: case
    6, float32, perturbation form around the initial state, at (nel, s, dt,
    steps) = (10,3,30,200) and (64,3,10,100) chained, and (64,4,30,100) in
    one packed_run launch beside the same steps chained; each with its
    grid points/s, launch counts (3 operator and 3 halo launches a step and
    one edge-trace bootstrap, no plain call; one launch a packed_run),
    device busy share (from a torch.profiler trace) and device span share
    (queued behind a sleep kernel, the card's launch gaps included), a
    finite state, mass drift below float32's machine epsilon, packed_run
    bit for bit equal to the chained kernels, and the bench's accuracy
    gate (the f32 perturbation RHS within 5e-3 of the tendency scale of the
    f64 truth at a 4-step drift state, the f32 absolute error beside it);
    then a float32, s=4, nel=32 case-6 INI through ``python -m
    wxfactory_tpu_torch`` for 50 steps with its launches counted;
20. time per call (the card's time, calls queued behind a sleep kernel
    between two CUDA events; and CUDA events around single calls, median),
    f64 and f32, beside the bounds: the operator (absolute RHS) and its
    perturbation mode (RHS; stage + x + traces) and their plain versions at
    (64,3), (64,4) and (64,7), the halo kernel against halo_from_traces, the
    edge-trace kernel against edge_traces, and a packed_run step against a
    chained step at (64,4).

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
SW_PERT_SHAPES = SHAPES + [(8, 4), (32, 4), (64, 4)]
KERNEL_SOURCES = ["sw_operator", "euler3d_operator", "sw_run"]
E3_SHAPES = [(3, 2, 2, 31), (12, 3, 2, 31), (4, 2, 3, 31), (20, 20, 3, 31), (4, 4, 4, 31), (3, 2, 5, 31),
             (2, 2, 6, 31), (4, 2, 3, 77)]
E3_MAIN = (20, 20, 3)
WORK = ROOT / "build" / "chip_smoke"
# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM bytes/s, and FLOP/s
# outside the tensor cores by type.
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}

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

DCMIP31_INI = """
[General]
equations = euler
[System]
precision = float64
[Test_case]
case_number = 31
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = {integrator}
exponential_solver = kiops
tolerance = 1e-7
verbose_solver = {verbose}
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
num_elements_vertical = {nel_v}
[Grid]
grid_type = cubed_sphere
ztop = 10000
[Output_options]
save_state_freq = {save}
output_dir = {out}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def emit_comparison(phase: int, rows, shape_keys) -> None:
    """One line per (shape, dtype) with the worst scaled error over the
    modes; every row goes to build/chip_smoke/phase<N>.json."""
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / f"phase{phase}.json").write_text(json.dumps(rows, indent=1))
    summary = {}
    for r in rows:
        key = tuple(r[k] for k in shape_keys) + (r["dtype"],)
        worst = summary.setdefault(key, {"err": 0.0, "traces_err": 0.0, "tol": r["tol"], "ok": True,
                                         "modes": 0})
        worst["err"] = max(worst["err"], r["err"])
        worst["traces_err"] = max(worst["traces_err"], r.get("traces_err", 0.0))
        worst["ok"] = worst["ok"] and r["ok"]
        worst["modes"] += 1
        for extra in ("base_err_bal", "base_err_plain"):
            if extra in r:
                worst[extra] = r[extra]
    emit({"phase": phase, "ok": all(r["ok"] for r in rows),
          "results": [dict(zip(shape_keys + ("dtype",), k), **v) for k, v in summary.items()]})


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
            k = re.search(r"(sw_operator|sw_run|sw_edges|euler3d_operator|euler3d_tangent)_kernelI([df])Li(\d+)E"
                          r"(Lb([01]))?", m.group(1))
            current = {"kernel": f"{k.group(1)} {'f64' if k.group(2) == 'd' else 'f32'} s={k.group(3)}"
                       + (" pert" if k.group(5) == "1" else "") if k else m.group(1)}
            rows.append(current)
        elif current is not None:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                current["stack_bytes"] = int(m.group(1))
                current["spill_store_bytes"] = int(m.group(2))
                current["spill_load_bytes"] = int(m.group(3))
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
    build.build_all(KERNEL_SOURCES)
    seconds = time.perf_counter() - t0
    WORK.mkdir(parents=True, exist_ok=True)
    info = {name: build.build_info.get(name, {"seconds": 0.0, "log": ""}) for name in KERNEL_SOURCES}
    (WORK / "ptxas.log").write_text("".join(i["log"] for i in info.values()))
    emit({
        "phase": 0, "gpu": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "nvcc": next((l for l in nvcc if "release" in l), nvcc[-1]), "sympy": sympy.__version__,
        "python": sys.version.split()[0], "build_s": seconds,
        "nvcc_s": {name: i["seconds"] for name, i in info.items()},
        "built_now": all(bool(i["log"]) for i in info.values()),
        "ptxas": ptxas_summary("".join(i["log"] for i in info.values())),
    })


def phase1(torch):
    from wxfactory_tpu_torch.kernels.check import compare_sw_operator

    rows = []
    for nel, s in SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_sw_operator(nel, s, dtype, device="cuda")
    emit_comparison(1, rows, ("nel", "s"))
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


def reset_counts():
    """Set every kernel wrapper's launch count, the plain tangent's call
    count, the Jacobian actions asked of the matvec closures and the host
    syncs to 0."""
    from wxfactory_tpu_torch.common import device
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op
    from wxfactory_tpu_torch.ops import sw_operator as swop
    from wxfactory_tpu_torch.solvers import matvec

    swop.launches = e3op.launches = e3op.tangent_launches = e3op.plain_tangent_calls = 0
    swop.pert_launches = swop.edge_launches = swop.halo_launches = swop.run_launches = swop.plain_calls = 0
    e3op.pert_launches = e3op.pert_tangent_launches = 0
    matvec.jacobian_actions = device.host_syncs = 0


def read_counts():
    from wxfactory_tpu_torch.common import device
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op
    from wxfactory_tpu_torch.ops import sw_operator as swop
    from wxfactory_tpu_torch.solvers import matvec

    return {"sw_operator": swop.launches, "sw_pert": swop.pert_launches, "sw_edges": swop.edge_launches,
            "sw_halo": swop.halo_launches, "sw_run": swop.run_launches, "sw_plain_calls": swop.plain_calls,
            "euler3d_operator": e3op.launches,
            "euler3d_tangent": e3op.tangent_launches, "euler3d_pert": e3op.pert_launches,
            "euler3d_pert_tangent": e3op.pert_tangent_launches, "plain_tangent_calls": e3op.plain_tangent_calls,
            "jacobian_actions": matvec.jacobian_actions, "host_syncs": device.host_syncs}


def phase3(torch):
    from wxfactory_tpu_torch import __main__ as cli
    from wxfactory_tpu_torch.output.state import load_state

    nsteps, nel = 360, 64
    out_dir = WORK / "phase3"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / "case6_nel64_s3.ini"
    ini.write_text(CASE6_INI.format(dt=10, t_end=3600, nel=nel, save=nsteps, out=out_dir))

    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = read_counts()["sw_operator"]
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


def phase5(torch):
    from wxfactory_tpu_torch.kernels.check import compare_euler3d_operator

    rows = []
    for nel_h, nel_v, s, case in E3_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_euler3d_operator(nel_h, nel_v, s, dtype, device="cuda", case=case)
    emit_comparison(5, rows, ("nel_h", "nel_v", "s", "case"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"3D kernel disagrees with its plain version: {bad}")
    main_path = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"], r["dtype"]) == E3_MAIN + ("float64",)]
    return max(r["max_abs_err"] for r in main_path)


def phase6(torch):
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    text = DCMIP31_INI.format(dt=2, t_end=20, s=2, nel_h=3, nel_v=2, save=0, out=WORK / "phase6",
                              integrator="tvdrk3", verbose=0)
    states = {}
    for device in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            states[device] = Simulation(Configuration(text), device=device).run().cpu()
    want, got = states["cpu"], states["cuda"]
    scale = want.abs().reshape(5, -1).amax(dim=1).reshape(5, 1, 1, 1, 1, 1)
    err = float(((got - want).abs() / scale).max())
    emit({"phase": 6, "case": 31, "steps": 10, "nel_h": 3, "nel_v": 2, "s": 2, "dtype": "float64", "err": err,
          "tol": 1e-10, "ok": err <= 1e-10})
    if not err <= 1e-10:
        raise AssertionError(f"GPU and CPU dcmip31 runs differ by {err} of scale")


def _dcmip31_run(torch, nel_h, nel_v, s, dt, nsteps, tag):
    """One dcmip31 run through the CLI on the card; checks launches, state,
    mass drift and checkpoints, returns its JSON row."""
    from wxfactory_tpu_torch import __main__ as cli
    from wxfactory_tpu_torch.kernels.check import euler3d_setup
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.output.state import load_state

    out_dir = WORK / f"phase7_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / f"dcmip31_{tag}.ini"
    ini.write_text(DCMIP31_INI.format(dt=dt, t_end=dt * nsteps, s=s, nel_h=nel_h, nel_v=nel_v, save=nsteps,
                                      out=out_dir, integrator="tvdrk3", verbose=0))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = read_counts()["euler3d_operator"]
    text = log.getvalue()
    sys.stderr.write(text[-2000:])
    if rc != 0:
        raise AssertionError(f"3D main path ({tag}) exited with {rc}")
    if launches != 3 * nsteps:
        raise AssertionError(f"{launches} kernel launches in {nsteps} TVD-RK3 steps, expected {3 * nsteps}")
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    states = {}
    for step in (0, nsteps):
        files = glob.glob(str(out_dir / f"state_vector_*.{step:08d}.npy"))
        if len(files) != 1:
            raise AssertionError(f"checkpoint files {files}")
        states[step], _, version = load_state(files[0])
    q = states[nsteps]
    shape = (5, 6, nel_v, nel_h, nel_h, s**3)
    if q.shape != shape or not bool(torch.isfinite(torch.as_tensor(q)).all()):
        raise AssertionError(f"checkpoint state {q.shape} not finite or misshapen")
    _, ops, metric, _, _ = euler3d_setup(nel_h, nel_v, s, 31)
    m0, m1 = global_mass_3d(states[0], ops, metric), global_mass_3d(q, ops, metric)
    drift = (m1 - m0) / m0
    if not abs(drift) < 1e-11:
        raise AssertionError(f"mass drift {drift} over {nsteps} steps")
    run_s = float(run.group(2))
    return {
        "case": 31, "nel_h": nel_h, "nel_v": nel_v, "s": s, "points": 6 * nel_v * nel_h * nel_h * s**3,
        "dtype": "float64", "integrator": "tvdrk3", "dt": dt, "steps": int(run.group(1)),
        "simulated_s": dt * nsteps, "setup_s": wall - run_s, "run_s": run_s,
        "steps_per_s": float(run.group(3)), "main_wall_s": wall, "launches": launches,
        "mass_drift": drift, "max_abs_w": float(abs(q[3] / q[0]).max()),
        "checkpoint": Path(files[0]).name, "checkpoint_version": version,
    }


def phase7(torch):
    main = _dcmip31_run(torch, *E3_MAIN, dt=0.1, nsteps=200, tag="main")
    canonical = _dcmip31_run(torch, 12, 3, 2, dt=0.5, nsteps=150, tag="canonical")
    emit({"phase": 7, "results": [main, canonical]})
    return main["launches"]


def phase8(torch, smi):
    from wxfactory_tpu_torch.kernels.check import euler3d_inputs, euler3d_work
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    rows = []
    for dtype in (torch.float64, torch.float32):
        con, topology, x, y = euler3d_inputs(*E3_MAIN, dtype, "cuda")
        traces = e3op.edge_traces(y, con)
        halo = e3op.halo_from_traces(traces, topology)
        kernel = lambda: e3op.euler3d_operator(y, halo, con)
        plain = lambda: e3op.euler3d_operator_plain(y, halo, con)
        stage = lambda: e3op.euler3d_operator(y, halo, con, x=x, a=0.75, b=0.25, cdt=0.025, emit_traces=True)
        glue = lambda: e3op.halo_from_traces(traces, topology)
        for fn in (kernel, plain, stage, glue):
            for _ in range(2):
                fn()
        torch.cuda.synchronize()
        k, p = [], []
        for fn, times in ((plain, p), (kernel, k), (kernel, k), (plain, p)):
            times.extend(_event_times(torch, fn, n=10))
        name = str(dtype).replace("torch.", "")
        row = {"nel_h": E3_MAIN[0], "nel_v": E3_MAIN[1], "s": E3_MAIN[2], "dtype": name,
               "kernel_rhs_ms": statistics.median(k), "plain_rhs_ms": statistics.median(p),
               "kernel_stage_traces_ms": statistics.median(_event_times(torch, stage)),
               "halo_glue_ms": statistics.median(_event_times(torch, glue)), "calls_each": len(k)}
        for mode, kw in (("rhs", {}), ("stage_traces", dict(stage=True, use_x=True, traces=True))):
            nbytes, ops = euler3d_work(con, **kw)
            bound = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[name] * 1e3}
            row[f"{mode}_bytes"], row[f"{mode}_ops"] = nbytes, ops
            row[f"{mode}_bound_ms"] = max(bound.values())
            row[f"{mode}_bound_by"] = max(bound, key=bound.get)
        rows.append(row)
    emit({"phase": 8, "gpu": smi, "timing": "CUDA events, median per call", "results": rows})
    return rows[0]


def phase9(torch):
    from wxfactory_tpu_torch.kernels.check import compare_euler3d_tangent

    rows = []
    for nel_h, nel_v, s, case in E3_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows.append(compare_euler3d_tangent(nel_h, nel_v, s, dtype, device="cuda", case=case))
    emit_comparison(9, rows, ("nel_h", "nel_v", "s", "case"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"tangent kernel disagrees with its plain version: {bad}")
    main_path = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"], r["dtype"]) == E3_MAIN + ("float64",)]
    return max(r["max_abs_err"] for r in main_path)


KRYLOV_LINE = re.compile(r"kiops converged at iteration (\d+) \((\d+) substeps, (\d+) rejected\) "
                         r"local error (\S+), last Krylov size (\d+)")


def phase10(torch):
    """The same EPI2 run on the GPU (tangent kernel) and on the CPU (plain
    tangent): the Krylov statistics of every step and the final states."""
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    nsteps = 2
    text = DCMIP31_INI.format(dt=30, t_end=30 * nsteps, s=2, nel_h=4, nel_v=2, save=0, out=WORK / "phase10",
                              integrator="epi2", verbose=1)
    states, stats = {}, {}
    for device in ("cuda", "cpu"):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            states[device] = Simulation(Configuration(text), device=device).run().cpu()
        stats[device] = [tuple(int(m.group(i)) for i in (1, 2, 3, 5)) for m in KRYLOV_LINE.finditer(log.getvalue())]
    want, got = states["cpu"], states["cuda"]
    scale = want.abs().reshape(5, -1).amax(dim=1).reshape(5, 1, 1, 1, 1, 1)
    err = float(((got - want).abs() / scale).max())
    same = stats["cuda"] == stats["cpu"] and len(stats["cpu"]) == nsteps
    emit({"phase": 10, "case": 31, "integrator": "epi2", "steps": nsteps, "nel_h": 4, "nel_v": 2, "s": 2,
          "dtype": "float64", "krylov_gpu": stats["cuda"], "krylov_cpu": stats["cpu"],
          "krylov_columns": ["iterations", "substeps", "rejected", "last_krylov_size"], "same_krylov": same,
          "err": err, "tol": 1e-10, "ok": same and err <= 1e-10})
    if not same:
        raise AssertionError(f"GPU and CPU EPI2 runs differ in Krylov statistics: {stats}")
    if not err <= 1e-10:
        raise AssertionError(f"GPU and CPU EPI2 runs differ by {err} of scale")


def _epi2_run(torch, nel_h, nel_v, s, nsteps, tag, profile_steps):
    """One dcmip31 EPI2+KIOPS run through the CLI on the card; checks the
    launch counts, state, mass drift and checkpoints, then profiles
    ``profile_steps`` steps of a second build; returns its JSON row."""
    from wxfactory_tpu_torch import __main__ as cli
    from wxfactory_tpu_torch.kernels.check import euler3d_setup
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.output.state import load_state
    from wxfactory_tpu_torch.profile import profile_simulation
    from wxfactory_tpu_torch.simulation import Simulation

    dt = 30.0
    out_dir = WORK / f"phase11_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / f"dcmip31_epi2_{tag}.ini"
    ini.write_text(DCMIP31_INI.format(dt=dt, t_end=dt * nsteps, s=s, nel_h=nel_h, nel_v=nel_v, save=1,
                                      out=out_dir, integrator="epi2", verbose=1))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    sys.stderr.write(text[-3000:])
    krylov = [tuple(int(m.group(i)) for i in (1, 2, 3, 5)) for m in KRYLOV_LINE.finditer(text)]
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if rc != 0 or run is None:
        raise AssertionError(f"EPI2 main path ({tag}) exited with {rc}; Krylov statistics per step "
                             f"(iterations, substeps, rejected, last size): {krylov}")
    if counts["euler3d_operator"] != nsteps:
        raise AssertionError(f"{counts['euler3d_operator']} RHS-kernel launches in {nsteps} EPI2 steps")
    if counts["euler3d_tangent"] != counts["jacobian_actions"] or counts["jacobian_actions"] == 0:
        raise AssertionError(f"tangent launches {counts['euler3d_tangent']} != Jacobian actions "
                             f"{counts['jacobian_actions']}")
    if counts["plain_tangent_calls"] != 0:
        raise AssertionError(f"{counts['plain_tangent_calls']} plain tangent calls on the card")
    if len(krylov) != nsteps or sum(k[0] for k in krylov) != counts["jacobian_actions"]:
        raise AssertionError(f"Krylov statistics {krylov} do not account for {counts['jacobian_actions']} actions")
    _, ops, metric, _, _ = euler3d_setup(nel_h, nel_v, s, 31)
    masses = []
    for step in range(nsteps + 1):
        files = glob.glob(str(out_dir / f"state_vector_*.{step:08d}.npy"))
        if len(files) != 1:
            raise AssertionError(f"checkpoint files {files}")
        q, _, version = load_state(files[0])
        masses.append(global_mass_3d(q, ops, metric))
    if q.shape != (5, 6, nel_v, nel_h, nel_h, s**3) or not bool(torch.isfinite(torch.as_tensor(q)).all()):
        raise AssertionError(f"checkpoint state {q.shape} not finite or misshapen")
    drifts = [(m - masses[0]) / masses[0] for m in masses[1:]]
    # KIOPS forms the first step's update from a Krylov combination that
    # cancels ~12 orders of magnitude at the balanced initial state, so
    # round-off of the (conservative) basis leaves a mass jump of a few
    # 1e-8 in the JAX package and the port alike (tools/epi2_mass_drift.py);
    # later steps move mass at ~1e-11. The gate is the KIOPS tolerance.
    drift = drifts[-1]
    if not max(abs(d) for d in drifts) < 1e-7:
        raise AssertionError(f"mass drift {drifts} over {nsteps} EPI2 steps")
    with contextlib.redirect_stdout(io.StringIO()):
        prof = profile_simulation(Simulation(str(ini), device="cuda"), steps=profile_steps, warmup=1)
    run_s = float(run.group(2))
    return {
        "case": 31, "nel_h": nel_h, "nel_v": nel_v, "s": s, "points": 6 * nel_v * nel_h * nel_h * s**3,
        "dtype": "float64", "integrator": "epi2", "exponential_solver": "kiops", "tolerance": 1e-7, "dt": dt,
        "steps": int(run.group(1)), "simulated_s": dt * nsteps, "setup_s": wall - run_s, "run_s": run_s,
        "steps_per_s": float(run.group(3)), "main_wall_s": wall, "rhs_launches": counts["euler3d_operator"],
        "tangent_launches": counts["euler3d_tangent"], "jacobian_actions": counts["jacobian_actions"],
        "plain_tangent_calls": counts["plain_tangent_calls"],
        "krylov_iterations": sum(k[0] for k in krylov), "substeps": sum(k[1] for k in krylov),
        "rejected": sum(k[2] for k in krylov), "last_krylov_size": krylov[-1][3],
        "krylov_per_step": krylov, "mass_drift": drift, "mass_drift_per_step": drifts,
        "mass_drift_after_step_1": (masses[-1] - masses[1]) / masses[1], "max_abs_w": float(abs(q[3] / q[0]).max()),
        "profiled_steps": profile_steps, "profiled_step_ms": prof["profiled_step_ms"],
        "device_busy_share": prof["device_busy_share"],
        "tangent_share_of_device_time": prof["tangent_kernel_us_per_step"] / prof["device_busy_us_per_step"],
        "profile_device_launches_per_step": prof["device_launches_per_step"],
        "profile_kernels_us_per_step": prof["kernels_us_per_step"][:6],
        "checkpoint": Path(files[0]).name, "checkpoint_version": version,
    }


def phase11(torch):
    canonical = _epi2_run(torch, 12, 3, 2, nsteps=10, tag="canonical", profile_steps=3)
    main = _epi2_run(torch, *E3_MAIN, nsteps=3, tag="main", profile_steps=1)
    emit({"phase": 11, "results": [canonical, main]})
    return main["tangent_launches"]


def phase12(torch, smi):
    from wxfactory_tpu_torch.kernels.check import euler3d_tangent_inputs, euler3d_tangent_work, tangent_halos
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op

    rows = []
    for dtype in (torch.float64, torch.float32):
        con, topology, q, v = euler3d_tangent_inputs(*E3_MAIN, dtype, "cuda")
        traces = e3op.edge_traces(q, con)
        halo_q, halo_v = tangent_halos(q, v, con, topology)
        kernel = lambda: e3op.euler3d_tangent(q, v, halo_q, halo_v, con)
        plain = lambda: e3op.euler3d_tangent_plain(q, v, halo_q, halo_v, con)
        glue = lambda: e3op.halo_from_traces(e3op.edge_traces_tangent(q, v, con, traces), topology)
        rhs = lambda: e3op.euler3d_operator(q, halo_q, con)
        for fn in (kernel, plain, glue, rhs):
            for _ in range(2):
                fn()
        torch.cuda.synchronize()
        k, p = [], []
        for fn, times in ((plain, p), (kernel, k), (kernel, k), (plain, p)):
            times.extend(_event_times(torch, fn, n=10))
        name = str(dtype).replace("torch.", "")
        nbytes, ops = euler3d_tangent_work(con)
        bound = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[name] * 1e3}
        rows.append({
            "nel_h": E3_MAIN[0], "nel_v": E3_MAIN[1], "s": E3_MAIN[2], "dtype": name,
            "tangent_kernel_ms": statistics.median(k), "tangent_plain_ms": statistics.median(p),
            "tangent_glue_ms": statistics.median(_event_times(torch, glue)),
            "rhs_kernel_ms": statistics.median(_event_times(torch, rhs)), "calls_each": len(k),
            "tangent_bytes": nbytes, "tangent_ops": ops, "tangent_bound_ms": max(bound.values()),
            "tangent_bound_by": max(bound, key=bound.get),
        })
    emit({"phase": 12, "gpu": smi, "timing": "CUDA events, median per call", "results": rows})
    return rows[0]


def phase13(torch):
    from wxfactory_tpu_torch.kernels.check import compare_euler3d_pert

    rows = []
    for nel_h, nel_v, s, case in E3_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_euler3d_pert(nel_h, nel_v, s, dtype, device="cuda", case=case)
    emit_comparison(13, rows, ("nel_h", "nel_v", "s", "case"))
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"perturbation kernel disagrees with its plain version: {bad}")
    main_path = [r for r in rows if (r["nel_h"], r["nel_v"], r["s"], r["dtype"], r["mode"]) ==
                 E3_MAIN + ("float32", "pert_tangent")]
    return max(r["max_abs_err"] for r in main_path)


KIOPS_JIT_LINE = re.compile(r"kiops_jit converged at iteration (\d+) \((\d+) substeps, (\d+) rejected\) "
                            r"local error (\S+), last Krylov size (\d+), (\d+) controls, (\d+) masked, "
                            r"(\d+) matvecs")


def kiops_jit_ini(mixed: int, chunk: int, **kw) -> str:
    return DCMIP31_INI.format(integrator="epi2", **kw).replace(
        "exponential_solver = kiops",
        f"exponential_solver = kiops_jit\nmixed_precision_krylov = {mixed}\ndevice_step_chunk = {chunk}")


def phase14(torch):
    """The same EPI2 kiops_jit runs on the GPU (kernels) and on the CPU
    (plain versions): float64 at 4x2x2, s=2 with identical Krylov
    statistics; mixed precision at 4x2x4, s=4, the shape at which the JAX
    package holds its two float32 companions to 2e-5 (at 4x2x2, s=2 two
    float32 operators part by ~2e-4 of rho*w's max after two steps, the JAX
    package's own two as much: the distance there is reported, not gated)."""
    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    nsteps, results = 2, []
    for mixed, s, tol in ((0, 2, 1e-10), (1, 4, 2e-5), (1, 2, None)):
        text = kiops_jit_ini(mixed, 1, dt=30, t_end=30 * nsteps, s=s, nel_h=4, nel_v=2, save=0,
                             out=WORK / "phase14", verbose=1)
        states, stats = {}, {}
        for device in ("cuda", "cpu"):
            log = io.StringIO()
            with contextlib.redirect_stdout(log):
                sim = Simulation(Configuration(text), device=device)
                with forbid_uncounted_syncs():
                    states[device] = sim.run()
            states[device] = states[device].cpu()
            stats[device] = [tuple(int(m.group(i)) for i in (1, 2, 3, 5)) for m in
                             KIOPS_JIT_LINE.finditer(log.getvalue())]
        want, got = states["cpu"], states["cuda"]
        scale = want.abs().reshape(5, -1).amax(dim=1).reshape(5, 1, 1, 1, 1, 1)
        err = float(((got - want).abs() / scale).max())
        same = stats["cuda"] == stats["cpu"] and len(stats["cpu"]) == nsteps
        ok = tol is None or (err <= tol and (same or mixed))
        results.append({"mixed_precision_krylov": mixed, "nel_h": 4, "nel_v": 2, "s": s,
                        "krylov_gpu": stats["cuda"], "krylov_cpu": stats["cpu"], "same_krylov": same, "err": err,
                        "tol": tol, "ok": ok})
    emit({"phase": 14, "case": 31, "integrator": "epi2", "exponential_solver": "kiops_jit", "steps": nsteps,
          "krylov_columns": ["iterations", "substeps", "rejected", "last_krylov_size"], "results": results,
          "ok": all(r["ok"] for r in results)})
    if not all(r["ok"] for r in results):
        raise AssertionError(f"GPU and CPU kiops_jit EPI2 runs differ: {results}")


def _kiops_jit_run(torch, nel_h, nel_v, s, nsteps, mixed, tag, profile_steps, chunk=5):
    """One dcmip31 EPI2 kiops_jit run (chunks of ``chunk`` steps, a
    checkpoint at each chunk's end) through ``Simulation(ini).run()``, the
    CLI's own call, on the card, with every wait of the host for the card
    but the counted ones raising (``forbid_uncounted_syncs``); checks the
    launch counts, syncs, state, mass drift at every checkpoint and the
    checkpoints, then profiles ``profile_steps`` steps of a second build
    (none when 0); returns its JSON row."""
    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.kernels.check import euler3d_setup
    from wxfactory_tpu_torch.output import global_mass_3d
    from wxfactory_tpu_torch.output.state import load_state
    from wxfactory_tpu_torch.profile import profile_simulation
    from wxfactory_tpu_torch.simulation import Simulation

    dt = 30.0
    out_dir = WORK / f"phase15_{tag}"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / f"dcmip31_kiops_jit_{tag}.ini"
    ini.write_text(kiops_jit_ini(mixed, chunk, dt=dt, t_end=dt * nsteps, s=s, nel_h=nel_h, nel_v=nel_v,
                                 save=chunk, out=out_dir, verbose=1))
    log = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        sim = Simulation(str(ini), device="cuda")
        with forbid_uncounted_syncs():
            sim.run()
    wall = time.perf_counter() - t0
    counts = read_counts()
    text = log.getvalue()
    sys.stderr.write(text[-3000:])
    krylov = [tuple(int(m.group(i)) for i in (1, 2, 3, 5, 6, 7, 8)) for m in KIOPS_JIT_LINE.finditer(text)]
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    if run is None:
        raise AssertionError(f"kiops_jit main path ({tag}) did not complete; Krylov statistics {krylov}")
    if "no effect" in text or "cannot consume" in text:
        raise AssertionError("mixed_precision_krylov was flagged as having no effect")
    # Mixed: one float64 RHS a step plus the float64 base RHS of the
    # companion at setup; every Krylov matvec is the perturbation tangent.
    tangent = "euler3d_pert_tangent" if mixed else "euler3d_tangent"
    if counts["euler3d_operator"] != nsteps + mixed:
        raise AssertionError(f"{counts['euler3d_operator']} RHS-kernel launches in {nsteps} steps")
    if counts[tangent] != counts["jacobian_actions"] or counts["jacobian_actions"] == 0:
        raise AssertionError(f"{tangent} launches {counts[tangent]} != Jacobian actions {counts['jacobian_actions']}")
    if counts["euler3d_tangent" if mixed else "euler3d_pert_tangent"] or counts["euler3d_pert"]:
        raise AssertionError(f"launches of another mode: {counts}")
    if counts["plain_tangent_calls"] != 0:
        raise AssertionError(f"{counts['plain_tangent_calls']} plain tangent calls on the card")
    controls = sum(k[4] for k in krylov)
    if len(krylov) != nsteps or sum(k[6] for k in krylov) != counts["jacobian_actions"]:
        raise AssertionError(f"Krylov statistics {krylov} do not account for {counts['jacobian_actions']} actions")
    # Counted waits: the controls, a NaN guard and a checkpoint a chunk, and
    # outside the steps the initial checkpoint and the run's final
    # synchronize. No other wait can have happened: forbid_uncounted_syncs
    # would have raised. The steps may wait the controls + 2 times a step.
    step_syncs = counts["host_syncs"] - 2
    if step_syncs > controls + 2 * nsteps:
        raise AssertionError(f"{step_syncs} host syncs for {controls} Krylov controls in {nsteps} steps")
    _, ops, metric, _, _ = euler3d_setup(nel_h, nel_v, s, 31)
    masses = {}
    for step in range(0, nsteps + 1, chunk):
        files = glob.glob(str(out_dir / f"state_vector_*.{step:08d}.npy"))
        if len(files) != 1:
            raise AssertionError(f"checkpoint files {files}")
        q, _, version = load_state(files[0])
        masses[step] = global_mass_3d(q, ops, metric)
    if q.shape != (5, 6, nel_v, nel_h, nel_h, s**3) or not bool(torch.isfinite(torch.as_tensor(q)).all()):
        raise AssertionError(f"checkpoint state {q.shape} not finite or misshapen")
    drifts = {k: (m - masses[0]) / masses[0] for k, m in masses.items() if k}
    if not max(abs(d) for d in drifts.values()) < 1e-7:
        raise AssertionError(f"mass drift {drifts} over {nsteps} steps")
    run_s = float(run.group(2))
    row = {
        "case": 31, "nel_h": nel_h, "nel_v": nel_v, "s": s, "points": 6 * nel_v * nel_h * nel_h * s**3,
        "dtype": "float64", "integrator": "epi2", "exponential_solver": "kiops_jit", "mixed_precision_krylov": mixed,
        "device_step_chunk": chunk, "tolerance": 1e-7, "dt": dt, "steps": int(run.group(1)),
        "setup_s": wall - run_s, "run_s": run_s, "steps_per_s": float(run.group(3)), "main_wall_s": wall,
        "rhs_launches": counts["euler3d_operator"], "tangent_launches": counts[tangent],
        "jacobian_actions": counts["jacobian_actions"], "plain_tangent_calls": counts["plain_tangent_calls"],
        "krylov_iterations": sum(k[0] for k in krylov), "substeps": sum(k[1] for k in krylov),
        "rejected": sum(k[2] for k in krylov), "controls": controls, "masked_iterations": sum(k[5] for k in krylov),
        "last_krylov_size": krylov[-1][3], "krylov_per_step": [k[:3] for k in krylov],
        "host_syncs": counts["host_syncs"], "host_syncs_per_step": step_syncs / nsteps,
        "controls_per_step": controls / nsteps, "mass_drift_per_checkpoint": drifts,
        "max_abs_w": float(abs(q[3] / q[0]).max()), "profiled_steps": profile_steps,
        "checkpoint": Path(files[0]).name, "checkpoint_version": version,
    }
    if not profile_steps:
        return row
    with contextlib.redirect_stdout(io.StringIO()):
        prof = profile_simulation(Simulation(str(ini), device="cuda"), steps=profile_steps, warmup=1)
    iters = prof["krylov_iterations_per_step"] or 1.0
    return dict(
        row, profiled_step_ms=prof["profiled_step_ms"], device_busy_share=prof["device_busy_share"],
        profile_krylov_iterations_per_step=prof["krylov_iterations_per_step"],
        profile_us_per_iteration={k: v / iters for k, v in prof["classes_us_per_step"].items()},
        profile_step_ms_per_iteration=prof["profiled_step_ms"] / iters,
        profile_device_launches_per_step=prof["device_launches_per_step"],
        profile_device_launches_per_iteration=prof["device_launches_per_step"] / iters,
        profile_host_syncs_per_step=prof["host_syncs_per_step"],
        profile_kernels_us_per_step=prof["kernels_us_per_step"][:6],
    )


def phase15(torch):
    rows = [
        _kiops_jit_run(torch, 12, 3, 2, nsteps=20, mixed=1, tag="canonical_mixed", profile_steps=3),
        # Mass at every step: chunks of one, a checkpoint after each.
        _kiops_jit_run(torch, 12, 3, 2, nsteps=20, mixed=1, tag="canonical_mixed_every_step", profile_steps=0,
                       chunk=1),
        _kiops_jit_run(torch, *E3_MAIN, nsteps=5, mixed=1, tag="main_mixed", profile_steps=1),
        _kiops_jit_run(torch, 12, 3, 2, nsteps=10, mixed=0, tag="canonical_f64", profile_steps=3),
        _kiops_jit_run(torch, *E3_MAIN, nsteps=5, mixed=0, tag="main_f64", profile_steps=1),
    ]
    emit({"phase": 15, "results": rows})
    return rows[2]["tangent_launches"]


def _arnoldi_ms(torch, matvec, vec, basis_dtype, full_ortho, m=64):
    """Milliseconds an Arnoldi iteration over one kiops_jit cycle of ``m``
    iterations (a small tau_end so the first control accepts), between CUDA
    events, with its statistics; the timed call under
    ``forbid_uncounted_syncs``."""
    from wxfactory_tpu_torch.common.device import forbid_uncounted_syncs
    from wxfactory_tpu_torch.solvers.kiops_jit import kiops_jit

    run = lambda: kiops_jit(matvec, vec, tau_end=1e-3, tol=1e-7, m_init=m, mmin=m, mmax=m,
                            full_ortho=full_ortho, basis_dtype=basis_dtype)
    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    with forbid_uncounted_syncs():
        _, stats = run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (stats.krylov_steps + stats.masked_iterations), stats


def phase16(torch, smi):
    from wxfactory_tpu_torch.kernels.check import euler3d_pert_inputs, euler3d_pert_work, euler3d_setup, pert_halos
    from wxfactory_tpu_torch.models import Euler3DRHS
    from wxfactory_tpu_torch.ops import euler3d_operator as e3op
    from wxfactory_tpu_torch.solvers.matvec import make_jvp_matvec

    rows = []
    for dtype in (torch.float64, torch.float32):
        con, topology, pert, dq, v = euler3d_pert_inputs(*E3_MAIN, dtype, "cuda")
        halo_dq, halo_v = pert_halos(dq, v, pert, con, topology)
        qa, tra = pert.q0 + dq, pert.traces0 + e3op.edge_traces_delta(dq, pert, con)
        kernel = lambda: e3op.euler3d_tangent(dq, v, halo_dq, halo_v, con, pert=pert)
        plain = lambda: e3op.euler3d_tangent_pert_plain(dq, v, halo_dq, halo_v, con, pert)
        glue = lambda: e3op.halo_from_traces(e3op.edge_traces_tangent(qa, v, con, tra), topology)
        rhs = lambda: e3op.euler3d_operator(dq, halo_dq, con, pert=pert)
        for fn in (kernel, plain, glue, rhs):
            for _ in range(2):
                fn()
        torch.cuda.synchronize()
        k, p = [], []
        for fn, times in ((plain, p), (kernel, k), (kernel, k), (plain, p)):
            times.extend(_event_times(torch, fn, n=5 if fn is plain else 10))
        name = str(dtype).replace("torch.", "")
        row = {"nel_h": E3_MAIN[0], "nel_v": E3_MAIN[1], "s": E3_MAIN[2], "dtype": name,
               "pert_tangent_kernel_ms": statistics.median(k), "pert_tangent_plain_ms": statistics.median(p),
               "pert_tangent_glue_ms": statistics.median(_event_times(torch, glue)),
               "pert_rhs_kernel_ms": statistics.median(_event_times(torch, rhs)), "calls_each": len(k)}
        for mode, tangent in (("pert_tangent", True), ("pert_rhs", False)):
            nbytes, ops = euler3d_pert_work(con, tangent=tangent)
            bound = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[name] * 1e3}
            row[f"{mode}_bytes"], row[f"{mode}_ops"] = nbytes, ops
            row[f"{mode}_bound_ms"] = max(bound.values())
            row[f"{mode}_bound_by"] = max(bound, key=bound.get)
        rows.append(row)

    # One Arnoldi iteration of each kiops_jit variant on the main path's
    # operators at the initial state (EPI2's first step, dt = 30 s).
    geom, ops, metric, topology, q0 = euler3d_setup(*E3_MAIN, 31)
    rhs = Euler3DRHS(geom, ops, metric, dtype=torch.float64, device="cuda", topology=topology)
    rhs32 = Euler3DRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology, perturbation_base=q0)
    q = torch.as_tensor(q0, device="cuda")
    rhs_q = rhs(q).reshape(-1)
    vec = torch.stack([torch.zeros_like(rhs_q), rhs_q])
    mv64, mv32 = make_jvp_matvec(rhs, q, 30.0), make_jvp_matvec(rhs32, q.float(), 30.0)
    arnoldi = {}
    for variant, (mv, bd, fo) in {"float64_iop2": (mv64, None, False),
                                  "mixed_cgs2": (mv32, torch.float32, True)}.items():
        ms, st = _arnoldi_ms(torch, mv, vec, bd, fo)
        arnoldi[variant] = {"ms_per_iteration": ms, "iterations": st.krylov_steps + st.masked_iterations,
                            "controls": st.controls}
    emit({"phase": 16, "gpu": smi, "timing": "CUDA events, median per call; Arnoldi: one 64-iteration cycle",
          "results": rows, "arnoldi": arnoldi})
    return rows[1]


def phase17(torch):
    """The SW perturbation mode, halo and edge-trace kernels against their
    plain versions; the whole-run kernel against its plain loop and the
    chained per-stage kernels."""
    from wxfactory_tpu_torch.kernels.check import compare_sw_edges, compare_sw_halo, compare_sw_pert, compare_sw_run

    rows = []
    for nel, s in SW_PERT_SHAPES:
        for dtype in (torch.float64, torch.float32):
            rows += compare_sw_pert(nel, s, dtype, device="cuda")
            rows += compare_sw_halo(nel, s, dtype, device="cuda") + compare_sw_edges(nel, s, dtype, device="cuda")
    runs = [compare_sw_run(nel, dtype, nsteps, pert, device="cuda")
            for nel in (32, 64) for dtype in (torch.float64, torch.float32)
            for pert in (False, True) for nsteps in (1, 2, 3)]
    emit_comparison(17, rows + runs, ("nel", "s"))
    keys = ("nel", "dtype", "mode", "nsteps", "err", "plain_err", "chain_err", "chain_max_abs_err", "bit_identical",
            "tol", "ok")
    emit({"phase": "17_whole_run", "ok": all(r["ok"] for r in runs),
          "bit_identical": sum(r["bit_identical"] for r in runs), "runs": len(runs),
          "results": [{k: r[k] for k in keys if k in r} for r in runs]})
    bad = [r for r in rows + runs if not r["ok"]]
    if bad:
        raise AssertionError(f"SW kernels disagree with their plain versions: {bad}")
    main = lambda rs, mode: max(r["max_abs_err"] for r in rs
                                if (r["nel"], r["s"], r["dtype"]) == (64, 4, "float32") and r["mode"].startswith(mode))
    return {"sw_pert": main(rows, "pert_"), "sw_halo": main(rows, "halo"), "sw_edges": main(rows, "edges"),
            "sw_run": main(runs, "run_pert")}


def phase18(torch):
    """GPU against CPU: the SW perturbation form through Tvdrk3, and
    packed_run, float64."""
    from wxfactory_tpu_torch.integrators import Tvdrk3
    from wxfactory_tpu_torch.kernels.check import sw_delta, sw_setup
    from wxfactory_tpu_torch.models import ShallowWaterRHS
    from wxfactory_tpu_torch.ops.sw_operator import tvdrk3_abc

    def scaled(got, want):
        scale = want.abs().reshape(3, -1).amax(dim=1).reshape(3, 1, 1, 1, 1)
        return float(((got - want).abs() / scale).max())

    results = []
    geom, ops, metric, topology, q0 = sw_setup(10, 3)
    states = {}
    for device in ("cuda", "cpu"):
        rhs = ShallowWaterRHS(geom, ops, metric, device=device, topology=topology, perturbation_base=q0)
        integ, q = Tvdrk3(rhs), torch.as_tensor(q0, device=device)
        for _ in range(10):
            q = integ.step(q, 30.0)
        states[device] = q.cpu()
    results.append({"run": "tvdrk3_perturbation", "nel": 10, "s": 3, "steps": 10, "dt": 30.0,
                    "err": scaled(states["cuda"], states["cpu"])})
    geom, ops, metric, topology, q0 = sw_setup(32, 4)
    for pert in (False, True):
        for device in ("cuda", "cpu"):
            rhs = ShallowWaterRHS(geom, ops, metric, device=device, topology=topology,
                                  perturbation_base=q0 if pert else None)
            q = torch.as_tensor(q0 + sw_delta(q0) if pert else q0, device=device)
            states[device] = rhs.unpack(rhs.packed_run(rhs.pack(q), 2, tvdrk3_abc(30.0))).cpu()
        results.append({"run": "packed_run_perturbation" if pert else "packed_run", "nel": 32, "s": 4, "steps": 2,
                        "dt": 30.0, "err": scaled(states["cuda"], states["cpu"])})
    ok = all(r["err"] <= 1e-10 for r in results)
    emit({"phase": 18, "dtype": "float64", "tol": 1e-10, "ok": ok, "results": results})
    if not ok:
        raise AssertionError(f"GPU and CPU SW runs differ: {results}")


# (nel, s, dt, steps, packed_run): bench.py:1021-1027's three SW operating points.
PRODUCTION = [(10, 3, 30.0, 200, False), (64, 3, 10.0, 100, False), (64, 4, 30.0, 100, True)]
GATE_REL = 5e-3  # bench.py:309
# Mass of a float32 state conserved to float32 round-off: its machine epsilon.
MASS_DRIFT_F32 = 2.0**-23

CASE6_F32_S4_INI = CASE6_INI.replace("precision = float64", "precision = float32").replace(
    "num_solpts = 3", "num_solpts = 4")


def _sw_gate(torch, nel, s, topology, geom, ops, metric, q0, rhs32):
    """bench.py:425-446: the f32 perturbation RHS against the f64 kernel
    truth at the initial state advanced four f64 TVD-RK3 steps of dt = 150
    (10/nel)(3/s), scaled by each variable's max tendency; the f32 absolute
    kernel's error beside it."""
    from wxfactory_tpu_torch.kernels.check import _scaled, per_variable_max
    from wxfactory_tpu_torch.models import ShallowWaterRHS

    rhs64 = ShallowWaterRHS(geom, ops, metric, device="cuda", topology=topology)
    dt = 150.0 * (10.0 / nel) * (3.0 / s)
    q = torch.as_tensor(q0, device="cuda")
    for _ in range(4):
        k1 = q + dt * rhs64(q)
        k2 = 0.75 * q + 0.25 * (k1 + dt * rhs64(k1))
        q = q / 3.0 + 2.0 / 3.0 * (k2 + dt * rhs64(k2))
    truth = rhs64(q)
    scale = per_variable_max(truth)
    err = _scaled(rhs32.delta((q - rhs32.base_state.double()).float()).double() - truth, scale)
    abs32 = ShallowWaterRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology)
    return err, _scaled(abs32(q.float()).double() - truth, scale)


def _sw_production(torch, nel, s, dt, nsteps, packed):
    """One SW operating point: f32 perturbation form around case 6's
    initial state, ``nsteps`` chained TVD-RK3 steps (and, with ``packed``,
    the same steps in one packed_run launch)."""
    from wxfactory_tpu_torch.integrators import Tvdrk3
    from wxfactory_tpu_torch.kernels.check import sw_setup
    from wxfactory_tpu_torch.models import ShallowWaterRHS
    from wxfactory_tpu_torch.ops.sw_operator import tvdrk3_abc
    from wxfactory_tpu_torch.output.diagnostics import global_integral_2d
    from wxfactory_tpu_torch.profile import profile_calls

    geom, ops, metric, topology, q0 = sw_setup(nel, s)
    t0 = time.perf_counter()
    rhs = ShallowWaterRHS(geom, ops, metric, dtype=torch.float32, device="cuda", topology=topology,
                          perturbation_base=q0)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gate, gate_abs = _sw_gate(torch, nel, s, topology, geom, ops, metric, q0, rhs)
    if not gate < GATE_REL:
        raise AssertionError(f"f32 perturbation RHS {gate} of the tendency scale from the f64 truth at "
                             f"({nel},{s}), gate {GATE_REL}")
    q_init = torch.as_tensor(q0, dtype=torch.float32, device="cuda")
    mass = lambda q: global_integral_2d(q[0].double().cpu().numpy(), ops, metric)
    mass0 = mass(q_init)
    points = 6 * nel * nel * s * s

    def chained():
        integ, q = Tvdrk3(rhs), q_init
        for _ in range(nsteps):
            q = integ.step(q, dt)
        return q, integ

    def check_state(q, what):
        if not bool(torch.isfinite(q).all()):
            raise AssertionError(f"{what} at ({nel},{s}) is not finite")
        drift = (mass(q) - mass0) / mass0
        if not abs(drift) < MASS_DRIFT_F32:
            raise AssertionError(f"{what} at ({nel},{s}): mass drift {drift}, limit {MASS_DRIFT_F32}")
        return drift

    def busy(fn, run_s):
        """The card's busy share of ``fn`` from a torch.profiler trace
        (None where the trace holds no device event), and its device span
        share: the same calls queued behind a sleep kernel, which also
        counts the card's gaps between dependent launches."""
        prof = profile_calls(fn)
        share = prof["device_busy_share"] if prof["device_ops"] > 0 else None
        return share, _device_ms(torch, fn, 1) * 1e-3 / run_s, prof

    Tvdrk3(rhs).step(q_init, dt)  # first launches (library load) outside the timed run
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    q, integ = chained()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    counts = read_counts()
    want = {"sw_pert": 3 * nsteps, "sw_halo": 3 * nsteps, "sw_edges": 1, "sw_operator": 0, "sw_run": 0,
            "sw_plain_calls": 0}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"chained run at ({nel},{s}): launches {got}, expected {want}")
    row = {"case": 6, "nel": nel, "s": s, "points": points, "dtype": "float32", "form": "perturbation",
           "integrator": "tvdrk3", "dt": dt, "steps": nsteps, "setup_s": setup_s, "chained_s": elapsed,
           "chained_gridpoints_per_s": points * 3 * nsteps / elapsed, "chained_steps_per_s": nsteps / elapsed,
           "chained_launches": got, "chained_mass_drift": check_state(q, "chained state"),
           "gate_err": gate, "gate_err_f32_absolute": gate_abs, "gate": GATE_REL}
    row["chained_device_busy_share"], row["chained_device_span_share"], prof = busy(chained, elapsed)
    row["chained_device_ops_per_step"] = prof["device_ops"] / nsteps
    row["chained_kernels_us"] = prof["kernels_us"][:4]
    launches = dict(got)
    if packed:
        abc = tvdrk3_abc(dt)
        qp = rhs.pack(q_init)
        rhs.packed_run(qp, 1, abc)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = rhs.packed_run(qp, nsteps, abc)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = read_counts()
        want = {"sw_run": 1, "sw_pert": 0, "sw_halo": 0, "sw_edges": 0, "sw_operator": 0, "sw_plain_calls": 0}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"packed_run at ({nel},{s}): launches {got}, expected {want}")
        launches["sw_run"] = 1
        chain_out = integ._cache[1]
        if not torch.equal(out, chain_out):
            raise AssertionError(f"packed_run at ({nel},{s}) differs from the chained kernels by up to "
                                 f"{float((out - chain_out).abs().max())}; the two are bit for bit equal")
        share, span, _ = busy(lambda: rhs.packed_run(qp, nsteps, abc), elapsed)
        row.update({
            "packed_run_s": elapsed, "packed_run_gridpoints_per_s": points * 3 * nsteps / elapsed,
            "packed_run_steps_per_s": nsteps / elapsed, "packed_run_launches": got,
            "packed_run_mass_drift": check_state(rhs.unpack(out), "packed_run state"),
            "packed_run_bit_identical_to_chain": True,
            "packed_run_device_busy_share": share, "packed_run_device_span_share": span,
        })
    return row, launches


def phase19(torch):
    from wxfactory_tpu_torch import __main__ as cli

    rows, totals = [], {}
    for point in PRODUCTION:
        row, launches = _sw_production(torch, *point)
        rows.append(row)
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    # The port's Simulation at float32, s=4 (absolute form, as the JAX
    # Simulation runs it): operator, halo and edge-trace kernels.
    nsteps, nel = 50, 32
    out_dir = WORK / "phase19_sim"
    out_dir.mkdir(parents=True, exist_ok=True)
    for old in glob.glob(str(out_dir / "state_vector_*")):
        Path(old).unlink()
    ini = WORK / "case6_f32_s4_nel32.ini"
    ini.write_text(CASE6_F32_S4_INI.format(dt=30, t_end=30 * nsteps, nel=nel, save=nsteps, out=out_dir))
    log = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(log):
        rc = cli.main([str(ini), "--device", "cuda"])
    counts = read_counts()
    text = log.getvalue()
    want = {"sw_operator": 3 * nsteps, "sw_halo": 3 * nsteps, "sw_edges": 1, "sw_pert": 0, "sw_run": 0,
            "sw_plain_calls": 0}
    got = {k: counts[k] for k in want}
    run = re.search(r"Completed (\d+) steps in (\S+) s \((\S+) steps/s\)", text)
    drifts = [float(v) for v in re.findall(r"normalized error for mass = (\S+)", text)]
    if rc != 0 or run is None or got != want:
        raise AssertionError(f"f32 s=4 CLI run exited with {rc}, launches {got}, expected {want}")
    sim = {"case": 6, "nel": nel, "s": 4, "dtype": "float32", "form": "absolute", "integrator": "tvdrk3",
           "dt": 30.0, "steps": int(run.group(1)), "steps_per_s": float(run.group(3)), "launches": got,
           "mass_drift": drifts[-1] if drifts else None}
    for k in ("sw_halo", "sw_edges"):
        totals[k] = totals.get(k, 0) + got[k]
    emit({"phase": 19, "results": rows, "simulation": sim, "launches_total": totals})
    return totals


def _device_ms(torch, fn, n):
    """The card's time a call of ``fn``: ``n`` calls queued behind a sleep
    kernel that outlasts the host's enqueueing of them, timed by two CUDA
    events, so the host's time between launches does not count (a single
    call between two events measures the host for kernels this short)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(4e9 * host_s) + 2_000_000)  # cycles: twice the host time at up to 2 GHz
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _pair_ms(torch, kernel, plain, n=10, n_plain=5):
    """A kernel call and its plain version: the card's time a call
    (``_device_ms``) and the median time of single calls between two CUDA
    events, in turns (plain, kernel, kernel, plain), which includes what the
    host adds between the events."""
    for fn in (kernel, plain):
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    k, p = [], []
    for fn, times, count in ((plain, p, n_plain), (kernel, k, n), (kernel, k, n), (plain, p, n_plain)):
        times.extend(_event_times(torch, fn, n=count))
    return {"kernel_ms": _device_ms(torch, kernel, n), "plain_ms": _device_ms(torch, plain, n_plain),
            "kernel_event_ms": statistics.median(k), "plain_event_ms": statistics.median(p)}


RUN_STEPS = 20


def phase20(torch, smi):
    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.ops import sw_operator as swop

    def bound(work, dtype):
        nbytes, ops = work
        b = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS[dtype] * 1e3}
        return {"bytes": nbytes, "ops": ops, "bound_ms": max(b.values()), "bound_by": max(b, key=b.get)}

    rows = []
    for nel, s in ((64, 3), (64, 4), (64, 7)):
        for dtype in (torch.float64, torch.float32):
            name = str(dtype).replace("torch.", "")
            con, topology, base, dq, x = check.sw_pert_inputs(nel, s, dtype, "cuda")
            traces = swop.sw_edges(dq, con)
            halo = swop.sw_halo(traces, topology)
            qa = (base.q0 + dq).contiguous()
            halo_a = swop.sw_halo(swop.sw_edges(qa, con), topology)
            stage = dict(x=x, a=0.75, b=0.25, cdt=7.5, emit_traces=True)
            row = {"nel": nel, "s": s, "dtype": name}
            pairs = {
                "rhs": (lambda: swop.sw_operator(qa, halo_a, con), lambda: swop.sw_operator_plain(qa, halo_a, con),
                        check.sw_work(nel, s, dtype)),
                "pert_rhs": (lambda: swop.sw_operator(dq, halo, con, base=base),
                             lambda: swop.sw_operator_pert_plain(dq, halo, con, base),
                             check.sw_pert_work(nel, s, dtype)),
                "pert_stage_traces": (lambda: swop.sw_operator(dq, halo, con, base=base, **stage),
                                      lambda: swop.sw_operator_pert_plain(dq, halo, con, base, **stage),
                                      check.sw_pert_work(nel, s, dtype, stage=True, use_x=True, traces=True)),
                "halo": (lambda: swop.sw_halo(traces, topology), lambda: swop.halo_from_traces(traces, topology),
                         check.sw_halo_work(nel, s, dtype)),
                "edges": (lambda: swop.sw_edges(dq, con), lambda: swop.edge_traces(dq, con),
                          check.sw_edges_work(nel, s, dtype)),
            }
            if s == 4:
                abc = swop.tvdrk3_abc(30.0)
                pairs[f"run_{RUN_STEPS}_steps"] = (
                    lambda: swop.sw_run(dq, RUN_STEPS, abc, con, topology, base=base),
                    lambda: swop.sw_run_plain(dq, RUN_STEPS, abc, con, topology, base=base),
                    check.sw_run_work(nel, s, dtype, RUN_STEPS, pert=True))

                def chained_step():
                    return swop.sw_chain(dq, 1, abc, con, topology, base=base, traces=traces)

                for _ in range(3):
                    chained_step()
                row["chained_step_event_ms"] = statistics.median(_event_times(torch, chained_step, n=20))
                row["chained_step_ms"] = _device_ms(torch, chained_step, 10)
            for mode, (kernel, plain, work) in pairs.items():
                slow = mode.startswith("run")
                times = _pair_ms(torch, kernel, plain, n=5 if slow else 10, n_plain=2 if slow else 5)
                row.update({f"{mode}_{key}": v for key, v in times.items()})
                row.update({f"{mode}_{key}": v for key, v in bound(work, name).items()})
            if s == 4:
                row["run_ms_per_step"] = row[f"run_{RUN_STEPS}_steps_kernel_ms"] / RUN_STEPS
                row["run_event_ms_per_step"] = row[f"run_{RUN_STEPS}_steps_kernel_event_ms"] / RUN_STEPS
            rows.append(row)
    emit({"phase": 20, "gpu": smi, "timing": "*_ms: the card's time a call (calls queued behind a sleep kernel, "
          "CUDA events); *_event_ms: CUDA events around single calls, median", "results": rows})
    return next(r for r in rows if (r["nel"], r["s"], r["dtype"]) == (64, 4, "float32"))


def sw_bound():
    import torch

    from wxfactory_tpu_torch.kernels.check import sw_work

    nbytes, ops = sw_work(64, 3, torch.float64)
    bound = {"bytes": nbytes / PEAK_BYTES * 1e3, "operations": ops / PEAK_FLOPS["float64"] * 1e3}
    return max(bound.values()), max(bound, key=bound.get)


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
    sw_err = phase1(torch)
    phase2(torch)
    sw_launches = phase3(torch)
    sw_timing = phase4(torch, smi)
    e3_err = phase5(torch)
    phase6(torch)
    e3_launches = phase7(torch)
    e3_timing = phase8(torch, smi)
    tangent_err = phase9(torch)
    phase10(torch)
    tangent_launches = phase11(torch)
    tangent_timing = phase12(torch, smi)
    pert_err = phase13(torch)
    phase14(torch)
    pert_launches = phase15(torch)
    pert_timing = phase16(torch, smi)
    sw_errs = phase17(torch)
    phase18(torch)
    sw_counts = phase19(torch)
    swt = phase20(torch, smi)
    sw_bound_ms, sw_bound_by = sw_bound()
    sw_entry = lambda name, mode, replaces, source="wxfactory_tpu_torch/csrc/sw_operator.cu": {
        "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": sw_counts[name],
        "max_abs_err": sw_errs[name], "ms": swt[f"{mode}_kernel_ms"], "plain_ms": swt[f"{mode}_plain_ms"],
        "bound_ms": swt[f"{mode}_bound_ms"], "bound_by": swt[f"{mode}_bound_by"], "library_ms": None}
    kernels = [
        {"name": "sw_operator", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/sw_operator.cu",
         "replaces": "wxfactory_tpu/ops/pallas_sw_gen.py:632", "launches": sw_launches,
         "max_abs_err": sw_err, "ms": sw_timing["kernel_rhs_ms"], "plain_ms": sw_timing["plain_rhs_ms"],
         "bound_ms": sw_bound_ms, "bound_by": sw_bound_by, "library_ms": None},
        {"name": "euler3d_operator", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/euler3d_operator.cu",
         "replaces": "wxfactory_tpu/ops/pallas_euler3d.py:2131", "launches": e3_launches,
         "max_abs_err": e3_err, "ms": e3_timing["kernel_rhs_ms"], "plain_ms": e3_timing["plain_rhs_ms"],
         "bound_ms": e3_timing["rhs_bound_ms"], "bound_by": e3_timing["rhs_bound_by"], "library_ms": None},
        {"name": "euler3d_tangent", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/euler3d_operator.cu",
         "replaces": "wxfactory_tpu/ops/pallas_euler3d.py:2131 (tangent mode)", "launches": tangent_launches,
         "max_abs_err": tangent_err, "ms": tangent_timing["tangent_kernel_ms"],
         "plain_ms": tangent_timing["tangent_plain_ms"], "bound_ms": tangent_timing["tangent_bound_ms"],
         "bound_by": tangent_timing["tangent_bound_by"], "library_ms": None},
        {"name": "euler3d_pert", "route": "cuda", "source": "wxfactory_tpu_torch/csrc/euler3d_operator.cu",
         "replaces": "wxfactory_tpu/ops/pallas_euler3d.py:2131 (perturbation mode)", "launches": pert_launches,
         "max_abs_err": pert_err, "ms": pert_timing["pert_tangent_kernel_ms"],
         "plain_ms": pert_timing["pert_tangent_plain_ms"], "bound_ms": pert_timing["pert_tangent_bound_ms"],
         "bound_by": pert_timing["pert_tangent_bound_by"], "library_ms": None},
        sw_entry("sw_pert", "pert_stage_traces", "wxfactory_tpu/ops/pallas_sw_gen.py:632 (perturbation mode)"),
        sw_entry("sw_halo", "halo", "wxfactory_tpu/ops/pallas_sw.py:374"),
        sw_entry("sw_edges", "edges", "wxfactory_tpu/ops/pallas_sw.py:258"),
        sw_entry("sw_run", f"run_{RUN_STEPS}_steps", "wxfactory_tpu/ops/pallas_sw.py:1100",
                 "wxfactory_tpu_torch/csrc/sw_run.cu"),
    ]
    unmeasured = [k["name"] for k in kernels if not (k["ms"] > 0 and k["plain_ms"] > 0 and k["launches"] > 0)]
    if unmeasured:
        raise AssertionError(f"kernels without a time, a plain time or a launch on the main path: {unmeasured}")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
