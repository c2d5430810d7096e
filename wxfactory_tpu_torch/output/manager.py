"""Output orchestration: field output, checkpoints, blockstats, the
solver-stats database and the runtime file.

Counterpart of ``wxfactory_tpu/output/manager.py``: the same NetCDF field
file at ``output_freq`` (``output/netcdf.py``; ``output_format = none``
writes none), the same checkpoint files (npy + version + INI, same
md5-keyed file names, so ``wxfactory_tpu.output.state.load_state`` reads
them) for both models, the shallow-water blockstats (case-1 and case-2
error norms; mass, energy and enstrophy drift; as in the JAX package they
print nothing for 3D Euler), the SQLite solver statistics of
``store_solver_stats`` (``output/solver_stats.py``, with the sampled RHS
stage times of ``rhs_timing_freq``) and, with ``store_total_time``, the
line ``runtime_<integrator>.txt`` gains at ``finalize``. FST output is not
ported (ROADMAP queue 1, item 15). On the Cartesian plane, as in the JAX
package, only checkpoints are written (the state as it is: ``panel_major``
False), with the solver statistics and the runtime file; no field file and
no blockstats.

Each step that owes a field write, a checkpoint or blockstats reads the
state from the card once. In a run over several ranks (``mesh``: the tile
step's ``TileMesh``) the state is gathered to rank 0, which alone writes
fields and checkpoints (``parallel.distributed.save_state_distributed``:
the single file, or past 256 MB a manifest and one shard a tile), prints
blockstats and keeps the database and the runtime file; a restart reads
either checkpoint form at any process count.
"""

import hashlib
import math
import os
import time
from typing import Optional

import numpy as np

from ..common.device import to_host
from ..parallel.distributed import is_primary

from .diagnostics import global_integral_2d, potential_enstrophy, total_energy
from .solver_stats import SolverStatsOutput
from .state import load_state, save_state


class OutputManager:
    def __init__(self, config, geom, ops, metric, mesh=None, topo=None):
        self.config = config
        self.geom = geom
        self.ops = ops
        self.metric = metric
        self.topo = topo  # the bottom topography (Topography): the energy's potential term, the fields' h
        self.mesh = mesh if mesh is not None and not mesh.owns_all else None
        self.primary = is_primary()

        self.output_dir = config.output_dir
        if self._any_output_enabled():
            os.makedirs(self.output_dir, exist_ok=True)

        self.solver_stats: Optional[SolverStatsOutput] = None
        if config.store_solver_stats and self.primary:
            self.solver_stats = SolverStatsOutput(config)
        self.writer = None
        self.panel_major = config.grid_type == "cubed_sphere"
        if (self.primary and config.output_freq > 0 and config.output_format == "netcdf"
                and config.grid_type == "cubed_sphere"):
            from .netcdf import make_writer

            path = os.path.join(self.output_dir, f"{config.base_output_file}.nc")
            self.writer = make_writer(path, geom, metric, ops, config.equations, topo=topo)

        # Same deterministic digest as the JAX package, so both name a
        # configuration's checkpoints identically.
        digest = hashlib.md5(repr(config.state_id_params()).encode()).hexdigest()
        self.config_hash = int(digest[:12], 16)
        self.initial_integrals = None
        self.last_drift = None  # (mass, energy, enstrophy) drift of the last blockstats
        self.num_writes = 0
        self.total_write_time = 0.0

    def _any_output_enabled(self) -> bool:
        c = self.config
        return any(f > 0 for f in (c.output_freq, c.save_state_freq, c.stat_freq)) or bool(
            c.store_solver_stats or c.store_total_time)

    # ------------------------------------------------------------------
    def state_file_name(self, step_id: int) -> str:
        base = f"state_vector_{self.config_hash:012x}"
        return os.path.join(self.output_dir, f"{base}.{step_id:08d}.npy")

    def load_state_from_file(self, step_id: int, expected_shape) -> np.ndarray:
        from ..parallel.distributed import load_state_distributed, primary_print

        path = self.state_file_name(step_id)
        state = load_state_distributed(path)[0] if self.panel_major else load_state(path, panel_major=False)[0]
        if tuple(state.shape) != tuple(expected_shape):
            raise ValueError(
                f"Saved state for step {step_id} has shape {state.shape}, expected {expected_shape}"
            )
        primary_print(f"Starting simulation from step {step_id} (rather than 0)")
        return state

    # ------------------------------------------------------------------
    def step(self, q, step_id: int, sim_time: float) -> None:
        """Per-step output actions; ``q`` is a torch tensor on any device,
        read to the host once when a field write, a checkpoint or blockstats
        is due."""
        c = self.config
        write = c.output_freq > 0 and step_id % c.output_freq == 0
        save = c.save_state_freq > 0 and step_id % c.save_state_freq == 0
        stats = c.stat_freq > 0 and step_id % c.stat_freq == 0
        if not (write or save or stats):
            return
        if self.mesh is not None:
            from ..parallel.distributed import gather_global, save_state_distributed

            if save:
                save_state_distributed(q, self.mesh, c, self.state_file_name(step_id))
            if write or stats:
                host = gather_global(q, self.mesh)  # None off the primary
                if host is not None:
                    if write:
                        self._write_fields(host, sim_time)
                    if stats:
                        self.__blockstats__(host, step_id)
            return
        host = to_host(q)
        if write:
            self._write_fields(host, sim_time)
        if save:
            save_state(host, c, self.state_file_name(step_id), panel_major=self.panel_major)
        if stats:
            self.__blockstats__(host, step_id)

    def _write_fields(self, host: np.ndarray, sim_time: float) -> None:
        """One field write of the host state (the JAX package's
        ``__write_result__``), timed in ``total_write_time``."""
        t0 = time.time()
        if self.writer is not None:
            if self.config.equations == "shallow_water":
                self.writer.write_sw(sim_time, host)
            else:
                self.writer.write_euler(sim_time, host)
        self.total_write_time += time.time() - t0
        self.num_writes += 1

    def store_rhs_timing(self, step_id: int, stage_times: dict) -> None:
        """The sampled per-stage RHS times (``output/rhs_timing.py``) into
        the solver-stats ``rhs_timing`` table."""
        if self.solver_stats is not None and stage_times:
            self.solver_stats.write_rhs_timing(step_id, list(stage_times.keys()), list(stage_times.values()))

    def store_solver_stats(self, step_id: int, solver_info, solve_time: float) -> None:
        """One ``results_data`` row: the integrator's ``solver_info`` of the
        step (or device chunk) ending at ``step_id`` and its solve time."""
        if self.solver_stats is not None and solver_info is not None:
            self.solver_stats.write_output(
                step_id,
                num_iterations=getattr(solver_info, "total_num_it", 0),
                solve_time=solve_time,
                num_substeps=getattr(solver_info, "num_substeps", 0) or 0,
                num_rejected=getattr(solver_info, "num_rejected", 0) or 0,
                error_estimate=getattr(solver_info, "error_estimate", 0.0) or 0.0,
            )

    def finalize(self, total_time: Optional[float] = None) -> None:
        """Close the field file and the database; with ``store_total_time``
        append the run's line to ``runtime_<integrator>.txt`` (the JAX
        package's format)."""
        if self.writer is not None:
            self.writer.close()
        if self.solver_stats is not None:
            self.solver_stats.close()
        if self.primary and self.config.store_total_time and total_time is not None:
            c = self.config
            path = os.path.join(self.output_dir, f"runtime_{c.time_integrator}.txt")
            with open(path, "a") as fh:
                fh.write(f"{c.exponential_solver} {c.num_elements_horizontal} {c.time_integrator} "
                         f"{c.case_number} {total_time:.3f}\n")

    def __blockstats__(self, q: np.ndarray, step_id: int):
        c = self.config
        if c.equations != "shallow_water":
            return
        from ..testcases.shallow_water import height_case1, height_case2

        h = q[0]
        u1 = q[1] / h
        u2 = q[2] / h

        print("=" * 96)
        print(f"Blockstats for timestep {step_id}")

        if c.case_number in (1, 2):
            h_anal = height_case1(self.geom, step_id * c.dt) if c.case_number == 1 else height_case2(self.geom)
            a_err = global_integral_2d(np.abs(h - h_anal), self.ops, self.metric)
            i_anal = global_integral_2d(np.abs(h_anal), self.ops, self.metric)
            a_err2 = global_integral_2d((h - h_anal) ** 2, self.ops, self.metric)
            i_anal2 = global_integral_2d(h_anal**2, self.ops, self.metric)
            l1 = a_err / i_anal
            l2 = math.sqrt(a_err2 / i_anal2)
            linf = np.max(np.abs(h - h_anal)) / np.max(h_anal)
            print(f"l1 = {l1} \t l2 = {l2} \t linf = {linf}")

        if c.case_number >= 2:
            energy = total_energy(h, u1, u2, self.metric, self.topo)
            enstrophy = potential_enstrophy(h, u1, u2, self.metric, self.ops)
            integrals = np.array(
                [
                    global_integral_2d(h, self.ops, self.metric),
                    global_integral_2d(energy, self.ops, self.metric),
                    global_integral_2d(enstrophy, self.ops, self.metric),
                ]
            )
            if self.initial_integrals is None:
                self.initial_integrals = integrals
                print(f"Integral of mass = {integrals[0]}")
                print(f"Integral of energy = {integrals[1]}")
                print(f"Integral of enstrophy = {integrals[2]}")
            drift = (integrals - self.initial_integrals) / self.initial_integrals
            self.last_drift = drift
            print(f"normalized error for mass = {drift[0]}")
            print(f"normalized error for energy = {drift[1]}")
            print(f"normalized error for enstrophy = {drift[2]}")
        print("=" * 96)
