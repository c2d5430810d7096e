"""Explicit time integrators (forward Euler, TVD-RK3).

Counterpart of ``wxfactory_tpu/integrators/explicit.py`` (reference
integrators/euler1.py and tvdrk3.py) for an RHS with the fused stage API
(``stage`` / ``traces``: the shallow-water and 3D Euler operators): a step
is one operator launch per RK stage. Each stage computes ``a*q0 + b*y + c*dt*RHS(y)`` and
emits its output's panel-edge traces, which the next stage — and the next
step — consumes, so only the first step bootstraps traces.

As the JAX package's ``_PackedChain`` (integrators/explicit.py:38-100
there), the stages run on the RHS's packed state (``rhs.pack``: the
perturbation q - q0 in the shallow-water perturbation form, the state itself
otherwise) and every step returns ``rhs.unpack`` of it in the model layout.
The packed twin and its traces ride along in a one-entry cache keyed on the
identity of the last returned state, so a run packs once, at its first step,
and a float32 run never re-quantises the absolute state into the delta.
"""

from .base import Integrator, SolverInfo


class _StageChain(Integrator):
    """Shared fused-stage stepping of the explicit integrators."""

    # (a, b, dt_coeff) per stage: q_{k+1} = a*q0 + b*q_k + dt_coeff*dt*RHS(q_k)
    stages = ()

    def __init__(self, rhs, **kwargs) -> None:
        super().__init__(**kwargs)
        self.rhs = rhs
        self._cache = None  # (returned state, its packed twin, the twin's traces)

    def __step__(self, q, dt):
        rhs = self.rhs
        if self._cache is not None and self._cache[0] is q:
            qp, traces = self._cache[1], self._cache[2]
        else:
            qp = rhs.pack(q)
            traces = rhs.traces(qp)
        y = qp
        for a, b, c in self.stages:
            y, traces = rhs.stage(qp, y, a, b, c * dt, traces)
        out = rhs.unpack(y)
        self._cache = (out, y, traces)
        self.solver_info = SolverInfo(total_num_it=1)
        return out


class Euler1(_StageChain):
    """First-order forward Euler."""

    stages = ((0.0, 1.0, 1.0),)


class Tvdrk3(_StageChain):
    """3rd-order total-variation-diminishing Runge-Kutta (Shu-Osher)."""

    stages = ((0.0, 1.0, 1.0), (0.75, 0.25, 0.25), (1.0 / 3.0, 2.0 / 3.0, 2.0 / 3.0))
