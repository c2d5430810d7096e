"""Whether the port's dcmip31 Ros2 system converges without a
preconditioner, by time step: one ``fgmres_jit`` solve of the Ros2 system
(I - dt/2 J) x = (I - dt/2 J) q0 + dt f(q0) at the initial state, per dt.

    python tools/ros2_fgmres_dt.py [--shape 20,20,3] [--dts 30,10,5,3,2,1] [--max-iterations 1200]

Runs on the card (float64, tolerance 1e-7, restart 20; the Jacobian
action is the tangent kernel). Prints one JSON line per dt: converged,
iterations, the final relative residual and the solve's seconds (host
clock with a final synchronize), and the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shape", default="20,20,3", help="nel_h,nel_v,num_solpts (default: 20,20,3)")
    parser.add_argument("--dts", default="30,10,5,3,2,1", help="time steps in seconds")
    parser.add_argument("--max-iterations", type=int, default=1200, help="a multiple of the restart, 20")
    args = parser.parse_args(argv)
    nel_h, nel_v, s = (int(x) for x in args.shape.split(","))

    import torch

    if not torch.cuda.is_available():
        print("ros2_fgmres_dt: needs a CUDA device", file=sys.stderr)
        return 2
    from wxfactory_tpu_torch.kernels.check import euler3d_setup
    from wxfactory_tpu_torch.models import Euler3DRHS
    from wxfactory_tpu_torch.solvers.fgmres_jit import fgmres_jit
    from wxfactory_tpu_torch.solvers.matvec import make_rat_matvec

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    geom, ops, metric, topology, q0 = euler3d_setup(nel_h, nel_v, s, 31)
    rhs = Euler3DRHS(geom, ops, metric, device="cuda", topology=topology)
    q = torch.as_tensor(q0, device="cuda")
    qv = q.reshape(-1)
    for dt in (float(x) for x in args.dts.split(",")):
        A = make_rat_matvec(rhs, q, dt)
        b = A(qv) + rhs(q).reshape(-1) * dt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = fgmres_jit(A, b, x0=qv, tol=1e-7, restart=20, max_outer=args.max_iterations // 20)
        torch.cuda.synchronize()
        print(json.dumps({"shape": [nel_h, nel_v, s], "dt": dt, "converged": info.converged,
                          "iterations": info.num_iter, "relative_residual": info.norm_r / info.norm_b,
                          "seconds": time.perf_counter() - t0, "gpu": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
