"""Output orchestration: checkpoints and blockstats.

Counterpart of ``wxfactory_tpu/output/manager.py`` for the outputs the
port has: the same checkpoint files (npy + version + INI, same md5-keyed
file names, so ``wxfactory_tpu.output.state.load_state`` reads them) for
both models, and the shallow-water blockstats (case-2 error norms; mass,
energy and enstrophy drift). As in the JAX package, the blockstats print
nothing for 3D Euler. Field output (NetCDF/FST), the solver-stats database and the
runtime file are not ported yet (ROADMAP queue 1, item 15) and raise when
configured.
"""

import hashlib
import math
import os

import numpy as np

from ..common.device import to_host

from .diagnostics import global_integral_2d, potential_enstrophy, total_energy
from .state import load_state, save_state


class OutputManager:
    def __init__(self, config, geom, ops, metric):
        if config.output_freq > 0:
            raise NotImplementedError(
                "field output (output_freq > 0) is not ported yet (ROADMAP queue 1, item 15)"
            )
        if config.store_solver_stats or config.store_total_time:
            raise NotImplementedError(
                "store_solver_stats / store_total_time are not ported yet (ROADMAP queue 1, item 15)"
            )
        self.config = config
        self.geom = geom
        self.ops = ops
        self.metric = metric

        self.output_dir = config.output_dir
        if config.save_state_freq > 0 or config.stat_freq > 0:
            os.makedirs(self.output_dir, exist_ok=True)

        # Same deterministic digest as the JAX package, so both name a
        # configuration's checkpoints identically.
        digest = hashlib.md5(repr(config.state_id_params()).encode()).hexdigest()
        self.config_hash = int(digest[:12], 16)
        self.initial_integrals = None
        self.last_drift = None  # (mass, energy, enstrophy) drift of the last blockstats

    # ------------------------------------------------------------------
    def state_file_name(self, step_id: int) -> str:
        base = f"state_vector_{self.config_hash:012x}"
        return os.path.join(self.output_dir, f"{base}.{step_id:08d}.npy")

    def load_state_from_file(self, step_id: int, expected_shape) -> np.ndarray:
        state, _, _ = load_state(self.state_file_name(step_id), parse_config=False)
        if tuple(state.shape) != tuple(expected_shape):
            raise ValueError(
                f"Saved state for step {step_id} has shape {state.shape}, expected {expected_shape}"
            )
        print(f"Starting simulation from step {step_id} (rather than 0)")
        return state

    # ------------------------------------------------------------------
    def step(self, q, step_id: int, sim_time: float) -> None:
        """Per-step output actions; ``q`` is a torch tensor on any device."""
        c = self.config
        save = c.save_state_freq > 0 and step_id % c.save_state_freq == 0
        stats = c.stat_freq > 0 and step_id % c.stat_freq == 0
        if not (save or stats):
            return
        host = to_host(q)
        if save:
            save_state(host, c, self.state_file_name(step_id))
        if stats:
            self.__blockstats__(host, step_id)

    def __blockstats__(self, q: np.ndarray, step_id: int):
        c = self.config
        if c.equations != "shallow_water":
            return
        from ..testcases.shallow_water import height_case2

        h = q[0]
        u1 = q[1] / h
        u2 = q[2] / h

        print("=" * 96)
        print(f"Blockstats for timestep {step_id}")

        if c.case_number == 2:
            h_anal = height_case2(self.geom)
            a_err = global_integral_2d(np.abs(h - h_anal), self.ops, self.metric)
            i_anal = global_integral_2d(np.abs(h_anal), self.ops, self.metric)
            a_err2 = global_integral_2d((h - h_anal) ** 2, self.ops, self.metric)
            i_anal2 = global_integral_2d(h_anal**2, self.ops, self.metric)
            l1 = a_err / i_anal
            l2 = math.sqrt(a_err2 / i_anal2)
            linf = np.max(np.abs(h - h_anal)) / np.max(h_anal)
            print(f"l1 = {l1} \t l2 = {l2} \t linf = {linf}")

        if c.case_number >= 2:
            energy = total_energy(h, u1, u2, self.metric)
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
