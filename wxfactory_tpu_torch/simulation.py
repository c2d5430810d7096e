"""Simulation: configuration -> geometry -> state -> integrator -> run.

Counterpart of ``wxfactory_tpu/simulation.py``: on the cubed sphere
shallow water (every case of the JAX package: 0, 1, 2, 5, 6, 8, 9 and 10,
cases 5 and 10 with their bottom topography) and 3D Euler (every DCMIP case
of it: 11, 12, 20, 21, 22, 31 and 77; 20-22 over terrain, 21 and 22 under
their Rayleigh sponge) with every integrator of the JAX package's ``Simulation``
(``_create_integrator``, its simulation.py:414-472): the explicit ones
(euler1, tvdrk3), the exponential ones (epi2..6, epi_stiff3..6 and
srerk3..6, with pmex, kiops, the low-synchronization solvers, exode or the
device-resident kiops_jit), Ros2 (with fgmres, gcrot or the device-resident
fgmres_jit; with a preconditioner, lu, ilu, p-mg or fv-mg,
``_create_preconditioner``), the implicit ones (backward_euler,
crank_nicolson, bdf2, sdirk) and rosexp2; imex2, partrosexp2 and strang_*
need a partitioned RHS and raise the JAX package's ``ValueError``. With
``mixed_precision_krylov`` the float32 perturbation-form companion feeds the
device solvers' Krylov loop. The step loop has the end-time clamp, the
post-step exponential modal filter (``expfilter_apply``; ``ops/filters.py``),
the NaN/Inf guard, ``device_step_chunk`` (equal steps run back to back with
the guard and outputs at the chunk's end; never with a filter or a
post-step hook), the outputs
(NetCDF fields, checkpoints, blockstats for shallow water only as in the JAX
package, the solver-stats database with sampled RHS stage times, the
runtime file; ``output/manager.py``). The device comes from the caller;
nothing moves to another device. The distributions the port has not
ported (ROADMAP queue 1, item 14) and the multigrid levels of DCMIP 11/12
(item 19) raise ``NotImplementedError`` naming their item.

On the Cartesian plane (``grid_type = cartesian2d``; the JAX package's
simulation.py:128-136) the run is the 2D Euler model of cases 1-4 (pill,
Gaussian bubble, colliding bubbles, cold density current;
``testcases.initialize_cartesian2d`` with ``bubble_theta`` and
``bubble_rad``) on ``EulerCartesianRHS`` (one launch of its DFR kernel an
RHS call or RK stage, one of its tangent kernel a J.v), with every
integrator and preconditioner above (p-mg and fv-mg with the Cartesian
level families), the exponential filter without a metric and the Rayleigh
sponge (``apply_sponge``), checkpoints in the JAX package's layout for this
grid and no field file or blockstats, as in the JAX package; no float32
companion (the JAX package builds none for this grid) and one process
only (the reference's ``allowed_pe_counts = 1``).

DCMIP 11 and 12 (tracer transport under prescribed winds) run as the JAX
package runs them (its simulation.py:100-127): the advection-only RHS
(``Euler3DAdvectionRHS``, its own kernel on the card) and a post-step hook
that overwrites the momenta with rho * the winds at t + dt
(``testcases.PrescribedWinds``, evaluated on the state's device), after the
filter and before the NaN guard. Every integrator above steps them (the
implicit, exponential and Rosenbrock ones through the advection operator's
Jacobian action, its own prep and apply kernels on the card), with lu or ilu;
p-mg and fv-mg raise naming ROADMAP item 19 (the JAX package's levels there
are the five-variable operator over all 5 + nt rows), a run over several
ranks naming item 14.

``[System] distribute`` follows the JAX package's rules
(``wxfactory_tpu/simulation.py:274-380``) over the processes of a run
(``parallel.distributed``): with 6N^2 ranks, ``auto`` takes the
tile-parallel TVD-RK3 step (one tile a rank, ``ShardMapTvdrk3``) for an
explicit cubed-sphere run with N dividing nel, ``shard_map`` insists on it,
and ``off`` runs one process. The tile step runs shallow water in the
working precision's absolute form, 3D Euler in float32 in the perturbation
form around the initial state, and float64 in the absolute form. Every
other multi-rank run raises (the port has no GSPMD analogue; ROADMAP item
14) rather than run each rank redundantly. Output, blockstats and
checkpoints gather to rank 0.
"""

import math
import time

import torch

from .common import device as _device
from .common.device import resolve_device
from .parallel import distributed as _dist
from .config import Configuration, load_configuration
from .geometry import make_cartesian_2d, make_cubed_sphere_2d, make_cubed_sphere_3d, make_metric_2d, make_metric_3d
from .integrators import (BackwardEuler, Bdf2, CrankNicolson, Epi, EpiStiff, Euler1, Ros2, RosExp2, SdirkLstable,
                          Srerk, Tvdrk3)
from .models import Euler3DAdvectionRHS, Euler3DRHS, EulerCartesianRHS, make_rhs_shallow_water
from .ops.dfr import make_dfr_operators
from .ops.filters import make_apply_filters
from .output import OutputManager
from .parallel import CubedSphereTopology, ShardMapTvdrk3, TileMesh
from .parallel.mesh import tile_n_for_world
from .testcases import PrescribedWinds, dcmip_planet_params, initial_state, initial_state_3d, initialize_cartesian2d

# The 3D cases with the Rayleigh sponge (extra_forcing in the JAX package).
SPONGE_CASES = (21, 22)
# The 3D cases of tracer transport under prescribed winds (advection_only there).
ADVECTION_CASES = (11, 12)

_ITEM_19 = ("ROADMAP queue 1, item 19: the multigrid levels of DCMIP 11/12 (the five-variable operator and its "
            "tangent over all 5 + nt rows, as the JAX package builds them) are not ported")
_ITEM_14 = ("ROADMAP queue 1, item 14: the port runs multi-rank only as the tile-parallel TVD-RK3 step; the GSPMD "
            "analogue (EPI/Ros2 across ranks) is not ported")


def plan_distribution(config, world: int):
    """N of the tile step's (6, N, N) mesh for this run over ``world``
    processes, or None for a single-process run; raises where the JAX
    package's rules (simulation.py:274-380 there) give a path the port has
    not ported, or where ``shard_map`` cannot apply."""
    c = config
    knob = getattr(c, "distribute", "auto")
    if c.grid_type == "cartesian2d" and world > 1:
        raise NotImplementedError(
            f"the Cartesian plane over {world} ranks: the reference runs it on one process (allowed_pe_counts = "
            f"1); {_ITEM_14}")
    if knob == "gspmd":
        raise NotImplementedError(f"distribute='gspmd': {_ITEM_14}")
    n = tile_n_for_world(world)
    if c.equations == "euler" and c.case_number in SPONGE_CASES and (world > 1 or knob == "shard_map"):
        raise NotImplementedError(
            f"the tile step of DCMIP {c.case_number} (its Rayleigh sponge; the JAX package's tile step has no "
            f"forcing hook either): {_ITEM_14}")
    explicit = c.time_integrator.lower() == "tvdrk3" and c.grid_type == "cubed_sphere"
    model_ok = c.equations == "shallow_water" or c.case_number >= 13
    tile_ok = explicit and model_ok and n is not None and c.num_elements_horizontal % n == 0
    if knob == "shard_map" and not tile_ok:
        raise ValueError(
            "distribute='shard_map' needs an explicit cubed-sphere run (tvdrk3 without forcing hooks) on 6*N^2 "
            f"ranks with N | nel (world size {world}, nel {c.num_elements_horizontal}, "
            f"{c.time_integrator})"
        )
    if world == 1:
        return None
    if c.equations == "euler" and c.case_number in ADVECTION_CASES:
        raise NotImplementedError(
            f"DCMIP {c.case_number} over {world} ranks (its advection-only RHS and prescribed winds; the JAX "
            f"package's tile step takes neither): {_ITEM_14}")
    if knob == "off" or not tile_ok:
        raise NotImplementedError(
            f"distribute={knob!r} with {world} ranks and {c.time_integrator} would run every rank redundantly: "
            + _ITEM_14
        )
    return n


class Simulation:
    def __init__(self, config: Configuration | str, device="cuda"):
        if isinstance(config, str):
            config = load_configuration(config)
        self.config = c = config
        self.device = resolve_device(device)

        n = plan_distribution(c, _dist.world_size())
        self.mesh = None if n is None else TileMesh(n, _dist.rank(), _dist.world_size())

        self.dtype = torch.float32 if c.precision == "float32" else torch.float64
        self.topo = None
        self.damping = None
        # (q, t) -> q after every step (DCMIP 11/12's wind overwrite), or None.
        self.post_step_hook = None
        self.cartesian = c.grid_type == "cartesian2d"
        self.advection = not self.cartesian and c.equations == "euler" and c.case_number in ADVECTION_CASES
        if self.cartesian:
            self.ops = make_dfr_operators(c.num_solpts)
            self.geom = make_cartesian_2d((c.x0, c.x1), (c.z0, c.z1), c.num_elements_horizontal,
                                          c.num_elements_vertical, c.num_solpts)
            self.metric = None
            self.topology = None
            q0 = initialize_cartesian2d(self.geom, c.case_number, c.bubble_theta, c.bubble_rad)
            self.rhs = EulerCartesianRHS(self.geom, self.ops, dtype=self.dtype, device=self.device)
        elif c.equations == "euler":
            self.ops = make_dfr_operators(c.num_solpts, three_d=True)
            scale, rotating = dcmip_planet_params(c.case_number)
            self.geom = make_cubed_sphere_3d(
                c.num_elements_horizontal, c.num_elements_vertical, c.num_solpts, c.ztop,
                c.lambda0, c.phi0, c.alpha0, deep=(c.depth_approx == "deep"),
                planet_scaling_factor=scale, planet_is_rotating=rotating,
            )
            self.topology = CubedSphereTopology(self.geom)
            # DCMIP 20-22 replace the geometry by the one with their
            # topography; the metric is built once, on the final geometry.
            q0, self.geom, self.metric, self.damping = initial_state_3d(
                self.geom, c.case_number, lambda g: make_metric_3d(g, self.ops, self.topology))
            if self.advection:
                # The JAX factory ignores base_state on this path: a float32
                # run is the absolute operator in float32.
                self.rhs = Euler3DAdvectionRHS(self.geom, self.ops, self.metric, dtype=self.dtype,
                                               device=self.device, topology=self.topology)
                self.post_step_hook = PrescribedWinds(self.geom, c.case_number, device=self.device).overwrite
            else:
                self.rhs = None if self.mesh is not None else Euler3DRHS(
                    self.geom, self.ops, self.metric, dtype=self.dtype, device=self.device, topology=self.topology,
                    # float32 cannot resolve the hydrostatic balance: the
                    # well-balanced offset around the initial state absorbs it.
                    base_state=(q0 if self.dtype == torch.float32 else None), damping=self.damping,
                )
        else:
            self.ops = make_dfr_operators(c.num_solpts)
            self.geom = make_cubed_sphere_2d(c.num_elements_horizontal, c.num_solpts, c.lambda0, c.phi0, c.alpha0)
            self.metric = make_metric_2d(self.geom)
            self.topology = CubedSphereTopology(self.geom)
            q0, self.topo = initial_state(self.geom, self.ops, c.case_number, c.matsuno_wave_type, c.matsuno_amp)
            if self.topo is not None and self.mesh is not None:
                raise NotImplementedError(
                    "the tile step with topography: the JAX package has none either (its _build_shard_maker "
                    f"returns None with topography, simulation.py:334 there); {_ITEM_14}")
            self.rhs = None if self.mesh is not None else make_rhs_shallow_water(
                self.geom, self.ops, self.metric, dtype=self.dtype, device=self.device,
                topology=self.topology, topo=self.topo,
            )
        self.output = OutputManager(c, self.geom, self.ops, self.metric, mesh=self.mesh, topo=self.topo)

        self.starting_step = 0
        if c.starting_step > 0:
            q0 = self.output.load_state_from_file(c.starting_step, q0.shape)
            self.starting_step = c.starting_step
        # The float32 companion of the Krylov loop (mixed_precision_krylov):
        # the perturbation form around the initial state (the JAX package's
        # simulation.py:140-162), with the bottom topography of cases 5 and
        # 10. Its Jacobian action is, for 3D Euler, the kernel's
        # perturbation tangent mode (none for the sponge cases 21 and 22:
        # the JAX perturbation form refuses extra_forcing), for shallow
        # water the tangent kernel of the absolute float32 operator (with
        # topography), as the JAX package takes jax.jvp of its companion's
        # XLA form there.
        self.rhs32 = None
        if getattr(c, "mixed_precision_krylov", False) and self.dtype == torch.float64 and not self.cartesian:
            if c.equations == "euler" and c.case_number >= 13 and self.damping is None:
                self.rhs32 = Euler3DRHS(
                    self.geom, self.ops, self.metric, dtype=torch.float32, device=self.device,
                    topology=self.topology, perturbation_base=q0,
                )
            elif c.equations == "shallow_water":
                self.rhs32 = make_rhs_shallow_water(
                    self.geom, self.ops, self.metric, dtype=torch.float32, device=self.device,
                    topology=self.topology, perturbation_base=q0, topo=self.topo,
                )

        self.initial_q = torch.as_tensor(q0, dtype=self.dtype, device=self.device)
        self.integrator = self._create_integrator()
        self.apply_filters = make_apply_filters(c, self.metric, device=self.device, dtype=self.dtype, geom=self.geom)
        self._rhs_probes = None  # built at the first rhs_timing sample

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

    def _create_preconditioner(self):
        """lu/ilu: ``Factorization`` (practical for small problems); p-mg and
        fv-mg: ``Multigrid.for_geometry`` (the JAX package's
        simulation.py:383-410); ``fv`` raises its ValueError."""
        c = self.config
        if c.preconditioner == "none":
            return None
        if self.mesh is not None:
            raise NotImplementedError(f"a preconditioner across ranks: {_ITEM_14}")
        if c.preconditioner in ("lu", "ilu"):
            from .precondition import Factorization

            return Factorization(self.rhs, c.preconditioner)
        if c.preconditioner in ("p-mg", "fv-mg"):
            from .precondition import Multigrid

            return Multigrid.for_geometry(
                self.geom,
                kind=c.preconditioner,
                num_levels=c.num_mg_levels,
                num_pre_smoothe=c.num_pre_smoothe,
                num_post_smoothe=c.num_post_smoothe,
                pseudo_cfl=c.pseudo_cfl,
                smoother=c.mg_smoother,
                solve_coarsest=c.mg_solve_coarsest,
                spectral_radii=c.exp_smoothe_spectral_radii,
                device=self.device,
            )
        raise ValueError(
            f"Preconditioner '{c.preconditioner}' is not available for this configuration "
            "(the reference gates all preconditioning off; here none/lu/ilu work everywhere "
            "and p-mg/fv-mg on every model family)"
        )

    def _create_integrator(self):
        c = self.config
        name = c.time_integrator.lower()
        if self.mesh is not None:
            return ShardMapTvdrk3(self._tile_step_maker(), verbose=c.verbose_solver)
        if self.advection and c.preconditioner in ("p-mg", "fv-mg"):
            raise NotImplementedError(f"{c.preconditioner} on DCMIP {c.case_number}: {_ITEM_19}; none, lu and ilu "
                                      "run these cases")
        pre = dict(verbose=c.verbose_solver, preconditioner=self._create_preconditioner())
        if name == "euler1":
            return Euler1(self.rhs, **pre)
        if name == "tvdrk3":
            return Tvdrk3(self.rhs, **pre)
        exponential = dict(tolerance=c.tolerance, exponential_solver=c.exponential_solver,
                           krylov_size=max(c.krylov_size, 1), **pre)
        if name.startswith("epi_stiff"):
            return EpiStiff(self.rhs, int(name.removeprefix("epi_stiff")), rhs32=self.rhs32, **exponential)
        if name.startswith("srerk"):
            return Srerk(self.rhs, int(name.removeprefix("srerk")), **exponential)
        if name.startswith("epi"):
            order = int(name.removeprefix("epi"))
            # Reference simulation.py:345 bootstraps multistep EPI with 10
            # Epi2 substeps for the first step(s).
            return Epi(self.rhs, order, init_substeps=(10 if order >= 3 else 1), rhs32=self.rhs32, **exponential)
        if name == "ros2":
            return Ros2(self.rhs, tolerance=c.tolerance, gmres_restart=c.gmres_restart,
                        linear_solver=c.linear_solver, rhs32=self.rhs32, **pre)
        if name == "rosexp2":
            # One RHS for the full and the implicit part, as the JAX package
            # builds it: the two share one linearisation.
            return RosExp2(self.rhs, self.rhs, tolerance=c.tolerance, restart=c.gmres_restart, **pre)
        if name == "sdirk":
            return SdirkLstable(self.rhs, tolerance=c.tolerance, **pre)
        if name in ("imex2", "partrosexp2") or name.startswith("strang_"):
            # These need a stiff/nonstiff RHS split, which neither package's
            # models provide (the JAX package raises the same error); the
            # integrators themselves (integrators/hybrid.py, splitting.py)
            # take user-provided splits.
            raise ValueError(
                f"Integrator {name} requires a partitioned (implicit/explicit) RHS, "
                "which is not available for the built-in models"
            )
        if name == "crank_nicolson":
            return CrankNicolson(self.rhs, tolerance=c.tolerance, **pre)
        if name == "bdf2":
            return Bdf2(self.rhs, tolerance=c.tolerance, **pre)
        if name == "backward_euler":
            return BackwardEuler(self.rhs, tolerance=c.tolerance, **pre)
        raise ValueError(f"Unrecognized time integrator: {c.time_integrator}")

    def _tile_step_maker(self):
        """dt -> the tile step of this run (JAX package simulation.py:327-380
        with the port's precision rules: shallow water absolute in the
        working dtype; 3D Euler float32 in the perturbation form around the
        initial state; float64 absolute). The kernels are built by rank 0
        before any rank launches one."""
        from .parallel.shard_map_euler3d_fused import make_shard_map_euler3d_step_fused
        from .parallel.shard_map_sw_fused import make_shard_map_sw_step_fused

        if self.device.type == "cuda":
            from .kernels.build import build_all

            if _dist.is_primary():
                build_all(["euler3d_operator" if self.config.equations == "euler" else "sw_operator"])
            _dist.barrier()
        q0 = self.initial_q.double().cpu().numpy()
        if self.config.equations == "euler":
            base = q0 if self.dtype == torch.float32 else None
            make = make_shard_map_euler3d_step_fused
        else:
            base, make = None, make_shard_map_sw_step_fused
        kw = dict(dtype=self.dtype, perturbation_base=base, device=self.device, topology=self.topology)
        return lambda dt: make(self.geom, self.ops, self.metric, self.mesh, dt, **kw)

    # ------------------------------------------------------------------
    def _check_finite(self, q, step_id: int) -> None:
        finite = _device.host_read(torch.isfinite(q).all())
        if self.mesh is not None:
            finite = _dist.all_true(finite)  # every rank raises together
        if not finite:
            raise RuntimeError(f"NaN/Inf detected in state after step {step_id}")

    def step(self, q, step_id: int, t: float):
        """One step: dt clamp near t_end, integrator, filter, post-step
        hook (at t + dt), NaN guard, outputs, solver statistics and RHS
        timing samples. Returns (q_new, new_time)."""
        c = self.config
        dt = min(c.dt, c.t_end - t) if c.t_end > t else c.dt
        t0 = time.time()
        q = self.integrator.step(q, dt)
        if self.apply_filters is not None:
            q = self.apply_filters(q, dt)
        if self.post_step_hook is not None:
            q = self.post_step_hook(q, t + dt)
        self._check_finite(q, step_id)
        # The NaN guard waits for the card: the solve time is the step's own.
        solve_time = time.time() - t0
        self.output.step(q, step_id, t + dt)
        self.output.store_solver_stats(step_id, self.integrator.solver_info, solve_time)
        self._maybe_sample_rhs_timing(q, step_id)
        return q, t + dt

    def _maybe_sample_rhs_timing(self, q, step_id: int) -> None:
        """Every ``rhs_timing_freq`` steps with ``store_solver_stats``: the
        per-stage RHS times (``output/rhs_timing.py``) at the state ``q``
        into the solver-stats database (the JAX package's
        simulation.py:496-507). A tile-step run has no whole-sphere RHS to
        time and samples none."""
        c = self.config
        if not (c.rhs_timing_freq > 0 and c.store_solver_stats and step_id % c.rhs_timing_freq == 0):
            return
        if self.rhs is None:
            return
        from .output.rhs_timing import make_stage_probes, sample

        if self._rhs_probes is None:
            self._rhs_probes = make_stage_probes(self.geom, self.ops, self.topology, self.rhs, q, c.equations)
        self.output.store_rhs_timing(step_id, sample(self._rhs_probes, q.device))

    def _chunk_len(self, step_id: int, t: float) -> int:
        """How many equal-dt steps may run as one chunk from ``step_id``:
        bounded by ``device_step_chunk``, the next step that owes a field
        write, a checkpoint, blockstats or an RHS timing sample, and the
        last full-dt step before the t_end clamp; 1 when chunking is off,
        with a filter or with a post-step hook (the JAX package's
        simulation.py:512-534)."""
        c = self.config
        chunk = getattr(c, "device_step_chunk", 1)
        if (chunk <= 1 or self.apply_filters is not None or self.post_step_hook is not None
                or not hasattr(self.integrator, "steps_device")):
            return 1
        full_dt_steps = int(math.floor((c.t_end - t) / c.dt + 1e-10))
        n = min(chunk, max(full_dt_steps, 1))
        freqs = [c.output_freq, c.save_state_freq, c.stat_freq]
        if c.store_solver_stats and c.rhs_timing_freq > 0:
            freqs.append(c.rhs_timing_freq)
        for f in freqs:
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
                # n equal steps back to back; the NaN guard, the outputs,
                # the solver statistics and the timing samples land at the
                # chunk's end (no configured event is skipped), so no host
                # read falls inside a chunk.
                t0 = time.time()
                q = self.integrator.steps_device(q, c.dt, n)
                step_id += n
                t += n * c.dt
                self._check_finite(q, step_id)
                solve_time = time.time() - t0
                self.output.step(q, step_id, t)
                self.output.store_solver_stats(step_id, self.integrator.solver_info, solve_time)
                self._maybe_sample_rhs_timing(q, step_id)
            else:
                step_id += 1
                q, t = self.step(q, step_id, t)
            if c.verbose_solver > 0 or step_id % max(1, num_steps // 10) == 0:
                _dist.primary_print(f"Step {step_id}/{self.starting_step + num_steps} (t = {t:.1f} s)", flush=True)
        if self.device.type == "cuda":
            _device.synchronize(self.device)
        seconds = time.time() - t_start
        self.output.finalize(total_time=seconds)
        done = step_id - self.starting_step
        rate = done / seconds if seconds > 0 else float("inf")
        ranks = f" x {self.mesh.world} ranks" if self.mesh is not None and self.mesh.world > 1 else ""
        _dist.primary_print(f"Completed {done} steps in {seconds!r} s ({rate!r} steps/s) on {self.device}{ranks}")
        return q
