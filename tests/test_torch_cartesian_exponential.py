"""The port's ``Simulation`` on the Cartesian plane with the exponential
integrators against the JAX ``Simulation`` on the same INI, on the CPU
(case 2 at 5 x 7 elements, s = 4, float64, dt = 1 s; the INI and the scale
of tests/test_torch_cartesian_simulation.py): EPI2 + KIOPS (2 steps) and
SRERK3 + KIOPS (1 step), each J.v the plain tangent (``torch.func.jvp`` of
the plain RHS; one launch of the tangent kernel on the card), within 1e-10
of scale with the same Krylov counts (EPI2's KIOPS lines, and the last
step's iterations, substeps and rejections).
"""

import pytest
import torch
from test_torch_cartesian_simulation import KRYLOV, _ini, _run_pair, _scaled

torch.set_num_threads(1)


@pytest.mark.parametrize("integrator,nsteps", [("epi2", 2), ("srerk3", 1)])
def test_exponential_runs_match_jax(tmp_path, integrator, nsteps):
    got, want, log, jlog, (stats, jstats) = _run_pair(_ini(tmp_path, integrator, 1.0, nsteps))
    assert KRYLOV.findall(log) == KRYLOV.findall(jlog)
    assert stats == jstats and stats[0] > 0
    assert _scaled(got, want) < 1e-10
