"""Per-stage RHS timing probes of production runs.

Counterpart of ``wxfactory_tpu/output/rhs_timing.py`` (the reference's
in-RHS stage timers, rhs/rhs.py:77-118, persisted a step to the
solver-stats ``rhs_timing`` table) with the same stage names. The port's
RHS is one kernel launch on the card (``full_rhs(fused)``: the operator
kernel's state mode), so the other stages are timed as the same partial
products the JAX package times apart: the extrapolation to the faces and
the interior derivative as ``torch.matmul`` products, the halo exchange as
the port's own halo functions. Sampled every ``rhs_timing_freq`` steps of
a real run; every probe is timed after a warm call, with the device
synchronised around its repetitions (``_timer``). ``torch.profiler``
(``python -m wxfactory_tpu_torch.profile``) gives the in-kernel breakdown
when more detail is needed.
"""

import time
from typing import Callable, Dict

import numpy as np
import torch

from ..common.constants import IDX_RHO_U1, IDX_RHO_U2


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timer(fn, device: torch.device, reps: int = 3) -> float:
    """Seconds a call of ``fn``: one warm call, then ``reps`` calls between
    two synchronisations of the device."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps


def make_stage_probes(geom, ops, topology, rhs, q0, equations: str) -> Dict[str, Callable]:
    """Zero-argument probes a stage of the RHS, closed over a representative
    state ``q0`` (a torch tensor on the run's device); the stage names of the
    reference's timing rows."""
    probes: Dict[str, Callable] = {"full_rhs(fused)": lambda: rhs(q0)}
    if topology is None:
        return probes
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=q0.dtype, device=q0.device)
    if equations == "shallow_water":
        ex, ey = t(ops.extrap_x), t(ops.extrap_z)
        dx, dy = t(ops.derivative_x), t(ops.derivative_z)
        itf_x, itf_y = q0 @ ex, q0 @ ey
        probes["extrapolation"] = lambda: (q0 @ ex, q0 @ ey)
        probes["interior_derivative"] = lambda: (q0 @ dx, q0 @ dy)
        probes["halo_exchange"] = lambda: topology.halo_scalars(itf_x[0], itf_y[0])
    elif equations == "euler":
        ss = ops.num_solpts**2
        ee = t(np.concatenate([np.asarray(ops.extrap_x3), np.asarray(ops.extrap_y3), np.asarray(ops.extrap_z3)],
                              axis=1))
        dd = t(ops.derivative_x3)
        itf = q0 @ ee
        itf_i, itf_j = itf[..., : 2 * ss], itf[..., 2 * ss : 4 * ss]
        probes["extrapolation"] = lambda: q0 @ ee
        probes["interior_derivative"] = lambda: q0 @ dd
        probes["halo_exchange"] = lambda: topology.halo_state_3d(itf_i, itf_j, (IDX_RHO_U1, IDX_RHO_U2))
    return probes


def sample(probes: Dict[str, Callable], device, reps: int = 3) -> Dict[str, float]:
    """Time every probe on ``device``; returns {stage: seconds}."""
    device = torch.device(device)
    return {name: _timer(fn, device, reps) for name, fn in probes.items()}
