"""Explicit time integrators (forward Euler, TVD-RK3).

Counterpart of ``wxfactory_tpu/integrators/explicit.py`` (reference
integrators/euler1.py and tvdrk3.py) for an RHS with the fused stage API
(``stage`` / ``traces``, the shallow-water operator): a step is one operator
launch per RK stage. Each stage computes ``a*q0 + b*y + c*dt*RHS(y)`` and
emits its output's panel-edge traces, which the next stage — and the next
step — consumes, so only the first step bootstraps traces. The chained
traces ride along in a one-entry cache keyed on the identity of the last
returned state.
"""

from .base import Integrator, SolverInfo


class _StageChain(Integrator):
    """Shared fused-stage stepping of the explicit integrators."""

    # (a, b, dt_coeff) per stage: q_{k+1} = a*q0 + b*q_k + dt_coeff*dt*RHS(q_k)
    stages = ()

    def __init__(self, rhs, **kwargs) -> None:
        super().__init__(**kwargs)
        self.rhs = rhs
        self._cache = None  # (returned state, its traces)

    def __step__(self, q, dt):
        if self._cache is not None and self._cache[0] is q:
            traces = self._cache[1]
        else:
            traces = self.rhs.traces(q)
        y = q
        for a, b, c in self.stages:
            y, traces = self.rhs.stage(q, y, a, b, c * dt, traces)
        self._cache = (y, traces)
        self.solver_info = SolverInfo(total_num_it=1)
        return y


class Euler1(_StageChain):
    """First-order forward Euler."""

    stages = ((0.0, 1.0, 1.0),)


class Tvdrk3(_StageChain):
    """3rd-order total-variation-diminishing Runge-Kutta (Shu-Osher)."""

    stages = ((0.0, 1.0, 1.0), (0.75, 0.25, 0.25), (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0))
