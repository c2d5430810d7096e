"""Where a run's time goes on the card: ``python -m wxfactory_tpu_torch.profile
config.ini [--steps N] [--warmup M]``.

Builds the configuration's Simulation on CUDA, takes ``--warmup`` steps, then
``--steps`` steps under ``torch.profiler`` (the CUDA activity only: every
number below is read from the device's events, and recording the host's
operators as well took 2-4 times as long on an H100's host), and prints one
JSON line: the card, host wall time per step (unprofiled and
profiled), device busy time per step and its share of the profiled window,
device operations (kernels and copies) per step, and device time per step by
kernel name (the largest first). Needs a CUDA
device; there is no CPU mode.
"""

import argparse
import json
import sys
import time


def profile(config_path: str, steps: int = 20, warmup: int = 10, top: int = 12) -> dict:
    import torch

    from .simulation import Simulation

    if not torch.cuda.is_available():
        raise RuntimeError("profile needs a CUDA device")
    return dict(profile_simulation(Simulation(config_path, device="cuda"), steps, warmup, top), config=config_path)


def profile_simulation(sim, steps: int = 20, warmup: int = 10, top: int = 12) -> dict:
    """``profile`` of a Simulation built on CUDA, from its initial state."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from .common import device

    q, t = sim.initial_q, 0.0
    step_id = 0
    iterations = []

    def run(n):
        nonlocal q, t, step_id
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            step_id += 1
            q, t = sim.step(q, step_id, t)
            info = getattr(sim.integrator, "solver_info", None)
            iterations.append(info.total_num_it if info is not None else 0)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n

    if warmup:
        run(warmup)
    syncs = device.host_syncs
    plain_step_s = run(steps)
    syncs = (device.host_syncs - syncs) / steps
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled_step_s = run(steps)
    kernels, launches = {}, 0
    for ev in prof.key_averages():
        # Device-side events only (kernels, copies); the CPU ops that
        # launched them carry the same device time again.
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + ev.self_device_time_total / steps
            launches += ev.count
    busy_us = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    classes = {}
    for k, v in kernels.items():
        classes[kernel_class(k)] = classes.get(kernel_class(k), 0.0) + v
    return {
        "gpu": torch.cuda.get_device_name(0), "steps": steps, "warmup": warmup,
        "step_ms": plain_step_s * 1e3, "profiled_step_ms": profiled_step_s * 1e3,
        "device_busy_us_per_step": busy_us, "device_busy_share": busy_us * 1e-6 / profiled_step_s,
        "device_launches_per_step": launches / steps,
        "kernels_us_per_step": [{"name": k[:90], "us": v} for k, v in ranked],
        "tangent_kernel_us_per_step": sum(v for k, v in kernels.items() if kernel_class(k) == "tangent_kernel"),
        "classes_us_per_step": classes, "host_syncs_per_step": syncs,
        "krylov_iterations_per_step": sum(iterations[-steps:]) / steps,
    }


def profile_calls(fn, repeats: int = 1, top: int = 8) -> dict:
    """Device busy share of ``repeats`` calls of ``fn`` (each ending with the
    card's work enqueued) under torch.profiler: host wall time a call with a
    final synchronize, device time a call (kernels and copies), its share of
    the wall time, device operations a call, the largest kernels and the
    device time by ``kernel_class``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, ops, classes = {}, 0, {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.self_device_time_total > 0:
            kernels[ev.key] = kernels.get(ev.key, 0.0) + ev.self_device_time_total / repeats
            ops += ev.count
    for k, v in kernels.items():
        classes[kernel_class(k)] = classes.get(kernel_class(k), 0.0) + v
    busy_us = sum(kernels.values())
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall * 1e3 / repeats, "device_busy_us": busy_us,
            "device_busy_share": busy_us * 1e-6 * repeats / wall, "device_ops": ops / repeats,
            "kernels_us": [{"name": k[:90], "us": v} for k, v in ranked], "classes_us": classes}


def kernel_class(name: str) -> str:
    """The class of a device event by its name: the operator's kernels (the
    tangent prep and apply apart), the basis products (cuBLAS GEMM/GEMV/dot
    kernels) or the rest."""
    if any(k in name for k in ("euler3d_tangent_apply_kernel", "euler3d_tangent_prep_kernel",
                               "euler_cartesian_tangent_kernel", "euler_cartesian_fv_tangent_kernel",
                               "euler3d_advection_tangent_")):
        return "tangent_kernel"
    if any(k in name for k in ("euler3d_interface_kernel", "euler3d_volume_kernel", "sw_operator_kernel",
                               "euler_cartesian_operator_kernel", "euler_cartesian_fv_kernel",
                               "euler3d_advection_interface_kernel", "euler3d_advection_volume_kernel")):
        return "rhs_kernel"
    low = name.lower()
    if any(k in low for k in ("gemm", "gemv", "dot_kernel", "splitkreduce", "cublas", "cutlass", "xmma")):
        return "basis_products"
    return "other"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="wxfactory_tpu_torch.profile", description=__doc__.split("\n")[0])
    parser.add_argument("config", help="Path to the simulation configuration (INI)")
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=10)
    args = parser.parse_args(argv)
    print(json.dumps(profile(args.config, args.steps, args.warmup)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
