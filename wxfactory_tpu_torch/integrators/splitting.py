"""Operator-splitting combinators.

Counterpart of ``wxfactory_tpu/integrators/splitting.py`` (reference
integrators/splitting.py): each step composes the steps of two integrators
over the parts of a split RHS; the states stay where the sub-integrators
put them."""

import numpy as np

from .base import Integrator


class LieSplitting(Integrator):
    def __init__(self, scheme1: Integrator, scheme2: Integrator, **kwargs):
        super().__init__(**kwargs)
        self.scheme1 = scheme1
        self.scheme2 = scheme2

    def __step__(self, q, dt: float):
        return self.scheme2.step(self.scheme1.step(q, dt), dt)


class StrangSplitting(Integrator):
    def __init__(self, scheme1: Integrator, scheme2: Integrator, **kwargs):
        super().__init__(**kwargs)
        self.scheme1 = scheme1
        self.scheme2 = scheme2

    def __step__(self, q, dt: float):
        q = self.scheme1.step(q, 0.5 * dt)
        q = self.scheme2.step(q, dt)
        return self.scheme1.step(q, 0.5 * dt)


class OS22Splitting(Integrator):
    """Two-stage, two-operator splitting with a free parameter
    (reference splitting.py:30-49)."""

    def __init__(self, scheme1: Integrator, scheme2: Integrator, os_param: float, **kwargs):
        super().__init__(**kwargs)
        self.scheme1 = scheme1
        self.scheme2 = scheme2
        a = os_param
        self.alpha = np.array(
            [[(2 * a - 1) / (2 * a - 2), 1 - a], [-1 / (2 * a - 2), a]]
        )

    def __step__(self, q, dt: float):
        for stage in range(self.alpha.shape[0]):
            if self.alpha[stage, 0] != 0:
                q = self.scheme1.step(q, self.alpha[stage, 0] * dt)
            if self.alpha[stage, 1] != 0:
                q = self.scheme2.step(q, self.alpha[stage, 1] * dt)
        return q
