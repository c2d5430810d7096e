"""The port's shallow-water initial states against the JAX package's, on
the CPU: every case the JAX ``Simulation._init_sw`` builds (0 circular
vortex, 1 cosine bell, 2, 5 with its topography, 6, 8 Galewsky, 9 Matsuno
in its three wave types, 10 unsteady zonal flow with its topography) at
nel = 4, s = 3, each field within 1e-12 of its max, through the port's
dispatch ``testcases.initial_state``; an unknown case raises the JAX
package's ValueError; the analytic heights of cases 0 and 1 at a later
time agree too. Case 1's bell leaves h = 0 outside it, where the shallow-
water operator divides 0 by 0: both packages' ``Simulation`` stop at the
first step with the NaN guard's error (a property of the reference).
"""

import numpy as np
import pytest

from wxfactory_tpu.geometry import make_cubed_sphere_2d as j_geom
from wxfactory_tpu.ops.dfr import make_dfr_operators as j_ops
from wxfactory_tpu import testcases as jtc
from wxfactory_tpu_torch import testcases as ttc
from wxfactory_tpu_torch.geometry import make_cubed_sphere_2d
from wxfactory_tpu_torch.ops.dfr import make_dfr_operators

NEL, S = 4, 3
TOL = 1e-12


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).reshape(want.shape[0], -1).max(axis=1) if want.ndim > 4 else np.abs(want).max()
    err = np.abs(got - want).reshape(want.shape[0], -1).max(axis=1) if want.ndim > 4 else np.abs(got - want).max()
    assert np.all(err <= tol * np.maximum(scale, 1e-300)), (err, scale)


@pytest.fixture(scope="module")
def grids():
    return (make_cubed_sphere_2d(NEL, S), make_dfr_operators(S)), (j_geom(NEL, S), j_ops(S))


def _jax_state(jg, jo, case, wave="rossby", amp=1e-5):
    topo = None
    if case == 0:
        q = jtc.circular_vortex(jg)
    elif case == 1:
        q = jtc.williamson_case1(jg)
    elif case == 2:
        q = jtc.williamson_case2(jg)
    elif case == 5:
        q, topo = jtc.williamson_case5(jg, jo)
    elif case == 6:
        q = jtc.williamson_case6(jg)
    elif case == 8:
        q = jtc.case_galewsky(jg)
    elif case == 9:
        q = jtc.case_matsuno(jg, wave, amp)
    else:
        q, topo = jtc.case_unsteady_zonal(jg, jo)
    return q, topo


@pytest.mark.parametrize("case", [0, 1, 2, 5, 6, 8, 9, 10])
def test_initial_state_matches_jax(grids, case):
    (tg, to), (jg, jo) = grids
    q, topo = ttc.initial_state(tg, to, case)
    jq, jtopo = _jax_state(jg, jo, case)
    _close(q, jq)
    assert (topo is None) == (jtopo is None)
    if topo is not None:
        for name in ("hsurf", "hsurf_itf_x1", "hsurf_itf_x2", "dzdx1", "dzdx2"):
            _close(getattr(topo, name), getattr(jtopo, name))


@pytest.mark.parametrize("wave", ["rossby", "eig", "wig"])
def test_matsuno_wave_types_match_jax(grids, wave):
    (tg, to), (jg, jo) = grids
    q, topo = ttc.initial_state(tg, to, 9, matsuno_wave_type=wave, matsuno_amp=2e-5)
    _close(q, _jax_state(jg, jo, 9, wave, 2e-5)[0])
    assert topo is None


def test_analytic_heights_match_jax(grids):
    (tg, _), (jg, _) = grids
    _close(ttc.height_case1(tg, 3600.0 * 30), jtc.height_case1(jg, 3600.0 * 30))
    for t in (0.0, 86400.0):
        h, omega = ttc.height_vortex(tg, t)
        jh, jomega = jtc.height_vortex(jg, t)
        _close(h, jh)
        _close(omega, jomega)


def test_unknown_case_raises_as_jax(grids):
    (tg, to), _ = grids
    with pytest.raises(ValueError, match="Unsupported shallow-water case 3"):
        ttc.initial_state(tg, to, 3)


def test_case1_stops_at_the_nan_guard_as_jax(tmp_path):
    import contextlib
    import io

    from wxfactory_tpu.config import Configuration as JConfiguration
    from wxfactory_tpu.simulation import Simulation as JSimulation
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    text = f"""
[General]
equations = shallow_water
[Test_case]
case_number = 1
[Time_integration]
dt = 300
t_end = 900
time_integrator = tvdrk3
[Spatial_discretization]
num_solpts = 3
num_elements_horizontal = {NEL}
[Grid]
grid_type = cubed_sphere
[Output_options]
output_dir = {tmp_path}
"""
    for sim in (lambda: JSimulation(JConfiguration(text)), lambda: Simulation(Configuration(text), device="cpu")):
        with pytest.raises(RuntimeError, match="NaN/Inf detected in state after step 1"):
            with contextlib.redirect_stdout(io.StringIO()):
                sim().run()
