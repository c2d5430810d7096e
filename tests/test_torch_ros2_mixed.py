"""The port's mixed-precision dcmip31 Ros2 (``Ros2(..., rhs32=)`` with
``fgmres_jit``: the float32 perturbation companion's rational matvec on a
float32 inner basis, the outer residuals and updates in float64) on the
CPU, at the inputs of tests/test_torch_ros2.py (4x2x2, s=2, dt = 30 s,
tolerance 1e-7, ``gmres_restart`` 20, two steps):

* within 5e-5 of the port's float64 run per variable and 2e-3 on rho*w,
  the gate of tests/test_euler3d.py:293-318;
* against the JAX CPU mixed run within the same gate: there the companion
  is the XLA perturbation form without ``jtv_prep``, whose ``.xla`` the JAX
  ``Ros2`` differentiates, the ABSOLUTE float32 operator (ROADMAP.md §3);
  the port's companion differentiates the perturbation form through its
  tangent, as the JAX package does on a TPU. Two float32 operators, both
  gated against float64 at 5e-5 / 2e-3, so the distance between them is
  held to that gate.
"""

from test_torch_ros2 import _jax_run, _port_run, _scaled


def test_mixed_ros2_within_the_gate_of_float64():
    f64, _, _, _ = _port_run("fgmres_jit")
    mixed, iters, actions, plain = _port_run("fgmres_jit", mixed=True)
    err = _scaled(mixed[-1], f64[-1])
    print(f"mixed Ros2 against float64, per variable: {err}")
    assert err[[0, 1, 2, 4]].max() < 5e-5 and err[3] < 2e-3, err
    assert all(i > 0 for i in iters) and actions == plain


def test_mixed_ros2_within_the_gate_of_jax_cpu_mixed():
    want, jiters = _jax_run("fgmres_jit", mixed=True)
    mixed, iters, _, _ = _port_run("fgmres_jit", mixed=True)
    err = _scaled(mixed[-1], want[-1])
    print(f"mixed Ros2 against the JAX CPU mixed run, per variable: {err}")
    assert err[[0, 1, 2, 4]].max() < 5e-5 and err[3] < 2e-3, (err, iters, jiters)
