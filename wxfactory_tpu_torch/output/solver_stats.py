"""Per-step solver statistics in SQLite.

Counterpart of ``wxfactory_tpu/output/solver_stats.py`` (the reference's
output/solver_stats.py, SolverStatsOutput) with the same schema, so one
reader takes either package's database: a run-parameter table
``run_param`` deduplicated by a hash of the discretization and solver
parameters, ``results_data`` (a row a step or device chunk: iterations,
substeps, rejections, solve time, error estimate, convergence) and
``rhs_timing`` (the sampled per-stage RHS times of ``output/rhs_timing.py``).
"""

import hashlib
import os
import sqlite3
import time
from typing import Optional, Sequence


class SolverStatsOutput:
    def __init__(self, config, db_path: Optional[str] = None):
        self.config = config
        os.makedirs(config.output_dir, exist_ok=True)
        self.db_path = db_path or os.path.join(config.output_dir, config.solver_stats_file)
        self.db = sqlite3.connect(self.db_path)
        self._create_tables()
        self.run_id = self._register_run()

    def _create_tables(self):
        cur = self.db.cursor()
        cur.execute(
            """CREATE TABLE IF NOT EXISTS run_param (
                run_id INTEGER PRIMARY KEY AUTOINCREMENT,
                param_hash TEXT UNIQUE,
                equations TEXT, case_number INTEGER, grid_type TEXT,
                num_solpts INTEGER, num_elements_horizontal INTEGER,
                num_elements_vertical INTEGER, dt REAL, time_integrator TEXT,
                exponential_solver TEXT, tolerance REAL, preconditioner TEXT,
                jacobian_method TEXT, created REAL)"""
        )
        cur.execute(
            """CREATE TABLE IF NOT EXISTS results_data (
                run_id INTEGER, step_id INTEGER, num_iterations INTEGER,
                num_substeps INTEGER, num_rejected INTEGER,
                solve_time REAL, error_estimate REAL, converged INTEGER,
                timestamp REAL)"""
        )
        cur.execute(
            """CREATE TABLE IF NOT EXISTS rhs_timing (
                run_id INTEGER, step_id INTEGER, stage TEXT, elapsed REAL)"""
        )
        self.db.commit()

    def _register_run(self) -> int:
        c = self.config
        values = (
            c.equations, c.case_number, c.grid_type, c.num_solpts, c.num_elements_horizontal,
            c.num_elements_vertical, c.dt, c.time_integrator, c.exponential_solver, c.tolerance,
            c.preconditioner, c.jacobian_method,
        )
        # The JAX package's hash of the same tuple: both packages name a
        # configuration's run_param row alike.
        h = hashlib.sha256(repr(values).encode()).hexdigest()[:16]
        cur = self.db.cursor()
        row = cur.execute("SELECT run_id FROM run_param WHERE param_hash = ?", (h,)).fetchone()
        if row:
            return row[0]
        cur.execute(
            "INSERT INTO run_param (param_hash, equations, case_number, grid_type, num_solpts,"
            " num_elements_horizontal, num_elements_vertical, dt, time_integrator,"
            " exponential_solver, tolerance, preconditioner, jacobian_method, created)"
            " VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (h,) + values + (time.time(),),
        )
        self.db.commit()
        return cur.lastrowid

    def write_output(self, step_id: int, num_iterations: int, solve_time: float, num_substeps: int = 0,
                     num_rejected: int = 0, error_estimate: float = 0.0, converged: bool = True):
        self.db.execute(
            "INSERT INTO results_data VALUES (?,?,?,?,?,?,?,?,?)",
            (self.run_id, step_id, num_iterations, num_substeps, num_rejected, solve_time, error_estimate,
             int(converged), time.time()),
        )
        self.db.commit()

    def write_rhs_timing(self, step_id: int, stages: Sequence[str], times: Sequence[float]):
        self.db.executemany(
            "INSERT INTO rhs_timing VALUES (?,?,?,?)",
            [(self.run_id, step_id, s, t) for s, t in zip(stages, times)],
        )
        self.db.commit()

    def close(self):
        self.db.close()
