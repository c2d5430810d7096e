"""Simulation: configuration -> geometry -> state -> integrator -> run.

Counterpart of ``wxfactory_tpu/simulation.py`` for the cubed sphere:
shallow water (Williamson cases 2 and 6) and 3D Euler (DCMIP cases 31 and
77) with the explicit integrators (euler1, tvdrk3), and 3D Euler with the
exponential ones (epi2..6, epi_stiff3..6, with kiops or the device-resident
kiops_jit, and with ``mixed_precision_krylov`` the float32 perturbation-form
companion of the Krylov loop), the step loop with the end-time clamp, the
NaN/Inf guard, ``device_step_chunk`` (equal steps run back to back with the
guard and outputs at the chunk's end), checkpoints and blockstats (shallow
water only, as in the JAX package). The device comes from the
caller; nothing moves to another device. Any other grid, case, integrator,
exponential solver or distribution raises ``NotImplementedError`` naming
its ROADMAP item.
"""

import math
import time

import torch

from .common import device as _device
from .common.device import resolve_device
from .config import Configuration, load_configuration
from .geometry import make_cubed_sphere_2d, make_cubed_sphere_3d, make_metric_2d, make_metric_3d
from .integrators import Epi, EpiStiff, Euler1, Tvdrk3
from .models import Euler3DRHS, make_rhs_shallow_water
from .ops.dfr import make_dfr_operators
from .output import OutputManager
from .parallel import CubedSphereTopology
from .testcases import dcmip_planet_params, initial_state, initial_state_3d


class Simulation:
    def __init__(self, config: Configuration | str, device="cuda"):
        if isinstance(config, str):
            config = load_configuration(config)
        self.config = c = config
        self.device = resolve_device(device)

        if c.grid_type != "cubed_sphere":
            raise NotImplementedError(
                f"grid {c.grid_type!r} is not ported yet (the port runs the cubed sphere; the "
                "Cartesian 2D models are ROADMAP queue 1, item 15)"
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
        if c.equations == "euler":
            self.ops = make_dfr_operators(c.num_solpts, three_d=True)
            scale, rotating = dcmip_planet_params(c.case_number)
            self.geom = make_cubed_sphere_3d(
                c.num_elements_horizontal, c.num_elements_vertical, c.num_solpts, c.ztop,
                c.lambda0, c.phi0, c.alpha0, deep=(c.depth_approx == "deep"),
                planet_scaling_factor=scale, planet_is_rotating=rotating,
            )
            self.topology = CubedSphereTopology(self.geom)
            q0 = initial_state_3d(self.geom, c.case_number)
            self.metric = make_metric_3d(self.geom, self.ops, self.topology)
            self.rhs = Euler3DRHS(
                self.geom, self.ops, self.metric, dtype=self.dtype, device=self.device, topology=self.topology,
                # float32 cannot resolve the hydrostatic balance: the
                # well-balanced offset around the initial state absorbs it.
                base_state=(q0 if self.dtype == torch.float32 else None),
            )
        else:
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
        # The float32 companion of the Krylov loop (mixed_precision_krylov):
        # the perturbation form around the initial state, whose Jacobian
        # action is the kernel's perturbation tangent mode (the JAX package's
        # simulation.py:140-162; 3D Euler only: shallow-water EPI is not
        # ported, and the forcing cases are refused above).
        self.rhs32 = None
        if getattr(c, "mixed_precision_krylov", False) and self.dtype == torch.float64:
            if c.equations == "euler" and c.case_number >= 13:
                self.rhs32 = Euler3DRHS(
                    self.geom, self.ops, self.metric, dtype=torch.float32, device=self.device,
                    topology=self.topology, perturbation_base=q0,
                )

        self.initial_q = torch.as_tensor(q0, dtype=self.dtype, device=self.device)
        self.integrator = self._create_integrator()

        if getattr(c, "mixed_precision_krylov", False):
            # The companion only feeds the device-resident Krylov solver;
            # flag the knob as a no-op otherwise (simulation.py:182-201 of
            # the JAX package).
            name = c.time_integrator.lower()
            consumes = (
                (name.startswith("epi") and c.exponential_solver == "kiops_jit")
                or (name == "ros2" and c.linear_solver.startswith("fgmres_jit"))
            )
            if self.rhs32 is None:
                print(
                    "WARNING: mixed_precision_krylov is set but no f32 companion RHS "
                    "is available for this model/case; the knob has no effect"
                )
            elif not consumes:
                print(
                    f"WARNING: mixed_precision_krylov is set but {c.time_integrator} with "
                    f"exponential_solver={c.exponential_solver!r}/linear_solver={c.linear_solver!r} "
                    "cannot consume it — use kiops_jit (Epi/Srerk) or fgmres_jit (Ros2)"
                )

    def _create_integrator(self):
        c = self.config
        name = c.time_integrator.lower()
        if name == "euler1":
            return Euler1(self.rhs, verbose=c.verbose_solver)
        if name == "tvdrk3":
            return Tvdrk3(self.rhs, verbose=c.verbose_solver)
        if name.startswith("epi"):
            if c.equations != "euler":
                raise NotImplementedError(
                    f"{c.time_integrator} on shallow water is not ported yet: the SW operator has no "
                    "Jacobian-action kernel, and torch.func.jvp cannot pass through a kernel (ROADMAP "
                    "queue 1, item 5)"
                )
            common = dict(tolerance=c.tolerance, exponential_solver=c.exponential_solver,
                          krylov_size=max(c.krylov_size, 1), verbose=c.verbose_solver,
                          rhs32=self.rhs32)
            if name.startswith("epi_stiff"):
                return EpiStiff(self.rhs, int(name.removeprefix("epi_stiff")), **common)
            order = int(name.removeprefix("epi"))
            # Reference simulation.py:345 bootstraps multistep EPI with 10
            # Epi2 substeps for the first step(s).
            return Epi(self.rhs, order, init_substeps=(10 if order >= 3 else 1), **common)
        raise NotImplementedError(
            f"time integrator {c.time_integrator!r} is not ported yet (the port runs euler1, tvdrk3 "
            "and, on 3D Euler, epi/epi_stiff with kiops or kiops_jit; Ros2 is ROADMAP queue 1, item 11)"
        )

    # ------------------------------------------------------------------
    def _check_finite(self, q, step_id: int) -> None:
        if not _device.host_read(torch.isfinite(q).all()):
            raise RuntimeError(f"NaN/Inf detected in state after step {step_id}")

    def step(self, q, step_id: int, t: float):
        """One step: dt clamp near t_end, integrator, NaN guard, outputs.
        Returns (q_new, new_time)."""
        c = self.config
        dt = min(c.dt, c.t_end - t) if c.t_end > t else c.dt
        q = self.integrator.step(q, dt)
        self._check_finite(q, step_id)
        self.output.step(q, step_id, t + dt)
        return q, t + dt

    def _chunk_len(self, step_id: int, t: float) -> int:
        """How many equal-dt steps may run as one chunk from ``step_id``:
        bounded by ``device_step_chunk``, the next step that owes a
        checkpoint or blockstats, and the last full-dt step before the t_end
        clamp; 1 when chunking is off (the JAX package's simulation.py:512-534)."""
        c = self.config
        chunk = getattr(c, "device_step_chunk", 1)
        if chunk <= 1 or not hasattr(self.integrator, "steps_device"):
            return 1
        full_dt_steps = int(math.floor((c.t_end - t) / c.dt + 1e-10))
        n = min(chunk, max(full_dt_steps, 1))
        for f in (c.output_freq, c.save_state_freq, c.stat_freq):
            if f > 0:
                n = min(n, (step_id // f + 1) * f - step_id)
        return max(n, 1)

    def run(self) -> torch.Tensor:
        c = self.config
        q = self.initial_q
        t = self.starting_step * c.dt
        step_id = self.starting_step
        num_steps = int(math.ceil((c.t_end - t) / c.dt)) if c.t_end > t else 0

        t_start = time.time()
        self.output.step(q, step_id, t)  # initial output
        while t < c.t_end - 1e-10:
            n = self._chunk_len(step_id, t)
            if n > 1:
                # n equal steps back to back; the NaN guard and the outputs
                # land at the chunk's end (no configured event is skipped).
                q = self.integrator.steps_device(q, c.dt, n)
                step_id += n
                t += n * c.dt
                self._check_finite(q, step_id)
                self.output.step(q, step_id, t)
            else:
                step_id += 1
                q, t = self.step(q, step_id, t)
            if c.verbose_solver > 0 or step_id % max(1, num_steps // 10) == 0:
                print(f"Step {step_id}/{self.starting_step + num_steps} (t = {t:.1f} s)", flush=True)
        if self.device.type == "cuda":
            _device.synchronize(self.device)
        seconds = time.time() - t_start
        done = step_id - self.starting_step
        rate = done / seconds if seconds > 0 else float("inf")
        print(f"Completed {done} steps in {seconds!r} s ({rate!r} steps/s) on {self.device}")
        return q
