"""The port's explicit integrators against the JAX package's on Williamson
case 6 (nel=10, s=3, dt=30, float64, CPU): the port chains one fused
operator stage per RK stage with emitted traces; the JAX integrators step
the XLA RHS. 1e-11 of each variable's max, as tests/test_pallas_gen.py
holds the JAX chained kernel path against the XLA one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wxfactory_tpu.geometry import make_cubed_sphere_2d, make_metric_2d
from wxfactory_tpu.integrators import Euler1 as JEuler1
from wxfactory_tpu.integrators import Tvdrk3 as JTvdrk3
from wxfactory_tpu.models import make_rhs_shallow_water as j_make_rhs
from wxfactory_tpu.ops.dfr import make_dfr_operators
from wxfactory_tpu.testcases import williamson_case6
from wxfactory_tpu_torch import interop
from wxfactory_tpu_torch.integrators import Euler1, Tvdrk3

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["tvdrk3", "euler1"])
def test_steps_match_jax(name):
    nel, s, dt, nsteps = 10, 3, 30.0, 3
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    q = williamson_case6(geom)

    jcls, cls = {"tvdrk3": (JTvdrk3, Tvdrk3), "euler1": (JEuler1, Euler1)}[name]
    jint = jcls(j_make_rhs(geom, ops, metric, dtype=jnp.float64, interior="xla"))
    qa = jnp.asarray(q)
    for _ in range(nsteps):
        qa = jint.step(qa, dt)
    want = np.asarray(qa)

    rhs = interop.shallow_water_rhs(geom, ops, metric)
    integ = cls(rhs)
    qt = interop.to_tensor(q)
    for _ in range(nsteps):
        qt = integ.step(qt, dt)
    got = interop.to_numpy(qt)

    scale = np.abs(want).max(axis=(1, 2, 3, 4), keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=1e-11)
    assert integ.num_completed_steps == nsteps


def test_chained_traces_equal_fresh_bootstrap():
    """Traces carried across steps equal the glue's extraction of the
    returned state (the next step may consume either)."""
    nel, s = 4, 3
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    rhs = interop.shallow_water_rhs(geom, ops, metric)
    integ = Tvdrk3(rhs)
    q = integ.step(interop.to_tensor(williamson_case6(geom)), 30.0)
    cached_q, cached_traces = integ._cache
    assert cached_q is q
    torch.testing.assert_close(cached_traces, rhs.traces(q), rtol=1e-13, atol=0)
