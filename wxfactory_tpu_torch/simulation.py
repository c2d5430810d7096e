"""Simulation: configuration -> geometry -> state -> integrator -> run.

Counterpart of ``wxfactory_tpu/simulation.py`` for the shallow-water
cubed-sphere branch with the explicit integrators (euler1, tvdrk3): the step
loop with the end-time clamp, the per-step NaN/Inf guard, checkpoints and
blockstats. The device comes from the caller; nothing moves to another
device. Any other model, integrator or distribution raises.
"""

import math
import time

import torch

from .config import Configuration, load_configuration
from .geometry import make_cubed_sphere_2d, make_metric_2d
from .integrators import Euler1, Tvdrk3
from .models import make_rhs_shallow_water
from .ops.dfr import make_dfr_operators
from .output import OutputManager
from .parallel import CubedSphereTopology
from .testcases import initial_state


def resolve_device(device) -> torch.device:
    """The torch device a run was asked for; a CUDA request without a
    usable GPU raises instead of running somewhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device is available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (cpu or cuda)")
    return dev


class Simulation:
    def __init__(self, config: Configuration | str, device="cuda"):
        if isinstance(config, str):
            config = load_configuration(config)
        self.config = c = config
        self.device = resolve_device(device)

        if c.grid_type != "cubed_sphere" or c.equations != "shallow_water":
            raise NotImplementedError(
                f"{c.grid_type}/{c.equations} is not ported yet (the port runs shallow water "
                "on the cubed sphere; 3D Euler is ROADMAP queue 1, items 9-10)"
            )
        if getattr(c, "distribute", "auto") not in ("auto", "off"):
            raise NotImplementedError(
                f"distribute={c.distribute!r}: multi-GPU runs are ROADMAP queue 1, item 14"
            )
        if c.filter_apply or c.expfilter_apply:
            raise NotImplementedError("modal filters are not ported yet (ROADMAP queue 1, item 12)")
        if c.preconditioner != "none":
            raise NotImplementedError("preconditioners are not ported yet (ROADMAP queue 1, item 13)")

        self.dtype = torch.float32 if c.precision == "float32" else torch.float64
        self.ops = make_dfr_operators(c.num_solpts)
        self.geom = make_cubed_sphere_2d(c.num_elements_horizontal, c.num_solpts, c.lambda0, c.phi0, c.alpha0)
        self.metric = make_metric_2d(self.geom)
        self.topology = CubedSphereTopology(self.geom)
        q0 = initial_state(self.geom, c.case_number)
        self.rhs = make_rhs_shallow_water(
            self.geom, self.ops, self.metric, dtype=self.dtype, device=self.device,
            topology=self.topology,
        )
        self.output = OutputManager(c, self.geom, self.ops, self.metric)

        self.starting_step = 0
        if c.starting_step > 0:
            q0 = self.output.load_state_from_file(c.starting_step, q0.shape)
            self.starting_step = c.starting_step
        self.initial_q = torch.as_tensor(q0, dtype=self.dtype, device=self.device)
        self.integrator = self._create_integrator()

    def _create_integrator(self):
        c = self.config
        name = c.time_integrator.lower()
        if name == "euler1":
            return Euler1(self.rhs, verbose=c.verbose_solver)
        if name == "tvdrk3":
            return Tvdrk3(self.rhs, verbose=c.verbose_solver)
        raise NotImplementedError(
            f"time integrator {c.time_integrator!r} is not ported yet (the port runs euler1 and "
            "tvdrk3; EPI is ROADMAP queue 1, item 5)"
        )

    # ------------------------------------------------------------------
    def step(self, q, step_id: int, t: float):
        """One step: dt clamp near t_end, integrator, NaN guard, outputs.
        Returns (q_new, new_time)."""
        c = self.config
        dt = min(c.dt, c.t_end - t) if c.t_end > t else c.dt
        q = self.integrator.step(q, dt)
        if not bool(torch.isfinite(q).all()):
            raise RuntimeError(f"NaN/Inf detected in state after step {step_id}")
        self.output.step(q, step_id, t + dt)
        return q, t + dt

    def run(self) -> torch.Tensor:
        c = self.config
        q = self.initial_q
        t = self.starting_step * c.dt
        step_id = self.starting_step
        num_steps = int(math.ceil((c.t_end - t) / c.dt)) if c.t_end > t else 0

        t_start = time.time()
        self.output.step(q, step_id, t)  # initial output
        while t < c.t_end - 1e-10:
            step_id += 1
            q, t = self.step(q, step_id, t)
            if c.verbose_solver > 0 or step_id % max(1, num_steps // 10) == 0:
                print(f"Step {step_id}/{self.starting_step + num_steps} (t = {t:.1f} s)", flush=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.time() - t_start
        done = step_id - self.starting_step
        rate = done / seconds if seconds > 0 else float("inf")
        print(f"Completed {done} steps in {seconds!r} s ({rate!r} steps/s) on {self.device}")
        return q
