"""Time-integrator base class.

Counterpart of ``wxfactory_tpu/integrators/base.py`` (reference
integrators/integrator.py:18-113): the `step` template tracks wall time,
convergence info, and optional preconditioner preparation; concrete schemes
implement `__step__`.
"""

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from time import time
from typing import Any, List, Optional


@dataclass
class SolverInfo:
    """Per-step convergence / cost report from the inner solver."""

    total_num_it: int = 0
    num_substeps: int = 0
    num_rejected: int = 0
    error_estimate: float = 0.0
    converged: bool = True
    residuals: List[Any] = field(default_factory=list)


class Integrator(ABC):
    def __init__(self, verbose: int = 0, output_manager=None, preconditioner=None) -> None:
        self.verbose = verbose
        self.output_manager = output_manager
        self.preconditioner = preconditioner
        self.solver_info: Optional[SolverInfo] = None
        self.latest_time: float = 0.0
        self.sim_time: float = -1.0
        self.failure_flag: int = 0
        self.num_completed_steps: int = 0

    @abstractmethod
    def __step__(self, q, dt: float):
        ...

    def __prestep__(self, q, dt: float) -> None:
        pass

    def step(self, q, dt: float):
        """Advance the state one timestep, with timing + stats accounting."""
        t0 = time()
        self.__prestep__(q, dt)
        if self.preconditioner is not None:
            self.preconditioner.prepare(dt, q)
        self.solver_info = None  # concrete __step__ fills it (or leaves None)
        result = self.__step__(q, dt)
        self.latest_time = time() - t0
        self.sim_time += dt
        self.num_completed_steps += 1
        return result

    def steps_device(self, q, dt: float, nsteps: int):
        """Advance ``nsteps`` equal timesteps: repeated single steps
        (semantics identical to calling `step` in a loop; `solver_info`
        reflects the last step)."""
        for _ in range(nsteps):
            q = self.step(q, dt)
        return q
