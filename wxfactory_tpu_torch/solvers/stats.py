"""Convergence statistics reported by the phi-function / Krylov solvers.

Counterpart of ``wxfactory_tpu/solvers/stats.py``."""

from dataclasses import dataclass


@dataclass
class PhiStats:
    """Stats tuple of the exponential solvers (same fields as the reference's
    kiops/pmex stats tuples, solvers/kiops.py:60-66)."""

    substeps: int = 0
    rejected: int = 0
    krylov_steps: int = 0
    num_expm: int = 0
    error_estimate: float = 0.0
    last_krylov_size: int = 0

    def as_tuple(self):
        return (
            self.substeps,
            self.rejected,
            self.krylov_steps,
            self.num_expm,
            self.error_estimate,
            self.last_krylov_size,
        )
