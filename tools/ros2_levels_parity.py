"""dcmip31 Ros2 + p-mg at many levels: the port against the JAX package on
the CPU, step by step.

    JAX_PLATFORMS=cpu python tools/ros2_levels_parity.py [--shape 2,20,2] [--dt 30] [--steps 2] [--ztop 10000]

Both packages run the same INI (dcmip31, tolerance 1e-7, gmres_restart 20,
the p-mg preconditioner of chip_smoke.py phase 33: 2 levels, erk3
smoother, pseudo_cfl 5, which ``linear_solver = auto`` takes with the host
FGMRES and its 400-iteration budget) through their ``Simulation``, one step
at a time. Prints one JSON line a step with each package's FGMRES
iterations, whether each converged or stagnated, and the two states'
distance (each variable's max |port - JAX| over its max), then a summary
line. The JAX package runs on the CPU only here; the port's CPU path is its
plain torch versions. A diagnostic, not a test: it is not part of Tier-1.
"""

import argparse
import contextlib
import io
import json
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

INI = """
[General]
equations = euler
[System]
distribute = off
[Test_case]
case_number = 31
[Time_integration]
dt = {dt}
t_end = {t_end}
time_integrator = ros2
tolerance = 1e-7
gmres_restart = 20
verbose_solver = 1
[Spatial_discretization]
num_solpts = {s}
num_elements_horizontal = {nel_h}
num_elements_vertical = {nel_v}
[Grid]
grid_type = cubed_sphere
ztop = {ztop}
[Preconditioning]
preconditioner = p-mg
num_mg_levels = 2
mg_smoother = erk3
pseudo_cfl = 5
[Output_options]
output_dir = {out}
"""
LINE = re.compile(r"fgmres (convergence|stagnation) at iteration (\d+)")


def _steps(sim, q, nsteps, to_numpy):
    """(per-step reports, states) of ``nsteps`` Simulation steps from q."""
    rows, states, t = [], [], 0.0
    for step_id in range(1, nsteps + 1):
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            q, t = sim.step(q, step_id, t)
        found = LINE.findall(log.getvalue())
        rows.append({"solves": [(kind, int(n)) for kind, n in found], "seconds": time.perf_counter() - t0})
        states.append(to_numpy(q))
    return rows, states


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", default="2,20,2", help="nel_h,nel_v,num_solpts (default: 2,20,2)")
    parser.add_argument("--dt", type=float, default=30.0)
    parser.add_argument("--steps", type=int, default=2)
    parser.add_argument("--ztop", type=float, default=10000.0)
    parser.add_argument("--out", default="build/ros2_levels_parity", help="the runs' output directory")
    args = parser.parse_args(argv)
    nel_h, nel_v, s = (int(x) for x in args.shape.split(","))

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    import torch

    from wxfactory_tpu.config import Configuration as JConfiguration
    from wxfactory_tpu.simulation import Simulation as JSimulation
    from wxfactory_tpu_torch.config import Configuration
    from wxfactory_tpu_torch.simulation import Simulation

    text = INI.format(dt=args.dt, t_end=args.dt * args.steps, s=s, nel_h=nel_h, nel_v=nel_v, ztop=args.ztop,
                      out=args.out)
    with contextlib.redirect_stdout(io.StringIO()):
        jsim = JSimulation(JConfiguration(text))
        psim = Simulation(Configuration(text), device="cpu")
    jrows, jstates = _steps(jsim, jsim.initial_q, args.steps, np.asarray)
    prows, pstates = _steps(psim, psim.initial_q, args.steps, lambda t: t.numpy())
    same = True
    for k, (jr, pr, js, ps) in enumerate(zip(jrows, prows, jstates, pstates), start=1):
        scale = np.abs(js).reshape(js.shape[0], -1).max(axis=1).reshape((-1,) + (1,) * (js.ndim - 1))
        err = float(np.abs((ps - js) / scale).max())
        same = same and jr["solves"] == pr["solves"]
        print(json.dumps({"step": k, "jax": jr, "port": pr, "state_err": err}), flush=True)
    stagnated = lambda rows: any(kind == "stagnation" for r in rows for kind, _ in r["solves"])
    print(json.dumps({"shape": [nel_h, nel_v, s], "dt": args.dt, "ztop": args.ztop, "steps": args.steps,
                      "same_iterations": same, "jax_stagnates": stagnated(jrows),
                      "port_stagnates": stagnated(prows), "torch": torch.__version__}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
