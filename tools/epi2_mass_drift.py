"""Mass drift of dcmip31 EPI2+KIOPS steps in the JAX package (and, with
--port, in the PyTorch port on the CPU), step by step.

    JAX_PLATFORMS=cpu python tools/epi2_mass_drift.py [--shape 12,3,2] [--steps 3] [--port]

Prints, per step, the relative change of the total mass sum(sqrt(g) w^3 rho)
since the initial state and the Krylov iterations; and, for the first
step, the largest mass-to-norm ratio of the vectors KIOPS hands to the
Jacobian action (the Krylov basis) beside the mass of the step's update:
the basis conserves mass to round-off, and what the update carries beyond
it comes from the combination of the basis.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", default="12,3,2", help="nel_h,nel_v,num_solpts (default: the canonical 12,3,2)")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--port", action="store_true", help="also run the port's Epi on the CPU")
    args = parser.parse_args(argv)
    nel_h, nel_v, s = (int(x) for x in args.shape.split(","))

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from wxfactory_tpu.geometry import make_cubed_sphere_3d, make_metric_3d
    from wxfactory_tpu.integrators import Epi
    from wxfactory_tpu.models import make_rhs_euler_cubesphere
    from wxfactory_tpu.ops.dfr import make_dfr_operators
    from wxfactory_tpu.solvers import kiops
    from wxfactory_tpu.solvers.matvec import make_jvp_matvec
    from wxfactory_tpu.testcases import dcmip_gravity_wave

    dt = 30.0
    geom = make_cubed_sphere_3d(nel_h, nel_v, s, 10000.0, planet_scaling_factor=125.0, planet_is_rotating=False)
    ops = make_dfr_operators(s, three_d=True)
    metric = make_metric_3d(geom, ops)
    q0 = dcmip_gravity_wave(geom)
    w = np.asarray(ops.weights)
    wq = np.einsum("i,j,k->ijk", w, w, w).reshape(-1)
    sg = np.asarray(metric.sqrtG)
    mass = lambda x: float(np.sum(sg * wq * np.asarray(x).reshape(q0.shape)[0]))
    m0 = mass(q0)
    rhs = make_rhs_euler_cubesphere(geom, ops, metric)

    ratios = []
    jac = make_jvp_matvec(rhs, jnp.asarray(q0), dt)

    def traced(v):
        v = np.asarray(v)
        norm = float(np.linalg.norm(v))
        if norm > 0:
            ratios.append(abs(mass(v)) / (abs(m0) * norm))
        return np.asarray(jac(v))

    vec = np.zeros((2, q0.size))
    vec[1] = np.asarray(rhs(jnp.asarray(q0))).ravel()
    phiv, _ = kiops([1.0], traced, vec, tol=1e-7, m_init=1, mmin=16, mmax=64)
    print(f"first step: max |mass(v)| / (m0 |v|) over {len(ratios)} Krylov vectors {max(ratios):.3e}; "
          f"mass of the update dt*w / m0 {mass(phiv[0]) * dt / m0:.3e}")

    integ = Epi(rhs, order=2, exponential_solver="kiops", tolerance=1e-7)
    q = jnp.asarray(q0)
    for k in range(args.steps):
        q = integ.step(q, dt)
        print(f"jax step {k + 1}: mass drift {(mass(q) - m0) / m0:.10e}, {integ.solver_info.total_num_it} Krylov "
              "iterations", flush=True)

    if args.port:
        from wxfactory_tpu_torch import interop
        from wxfactory_tpu_torch.integrators import Epi as PortEpi

        pinteg = PortEpi(interop.euler3d_rhs(geom, ops, metric), order=2, tolerance=1e-7)
        qt = interop.to_tensor(q0)
        for k in range(args.steps):
            qt = pinteg.step(qt, dt)
            print(f"port (cpu) step {k + 1}: mass drift {(mass(qt.numpy()) - m0) / m0:.10e}, "
                  f"{pinteg.solver_info.total_num_it} Krylov iterations", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
