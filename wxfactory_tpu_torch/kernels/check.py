"""Hold the SW operator's CUDA kernel against its plain torch version on
the same inputs (Williamson case 6 with a seeded perturbation).

Tolerances, per variable, on the error scaled as stated:

* float64: 5e-12, the JAX kernel test's bound (tests/test_pallas_gen.py);
* float32: 1e-5 (sums in another order, f32 sqrt and divide).

Errors are scaled by each variable's max of the plain output, with one
exception: float32 RHS-mode outputs are scaled by each variable's max
flux-divergence term ``inv_sqrtG * div(F)``. The case-6 RHS is the residual
of terms 400 to 28,000 times larger at the checked shapes, so f32 round-off
in another summation order is that many times larger than the RHS's own
ulp: the plain f32 RHS differs from the f64 one by 1e-3 of its max at
nel=64, s=3. The error scaled by the RHS max is reported beside it.
"""

import numpy as np
import torch

from ..common.constants import GRAVITY
from ..geometry import make_cubed_sphere_2d, make_metric_2d
from ..ops import sw_operator as swop
from ..ops.dfr import make_dfr_operators
from ..parallel.topology import CubedSphereTopology
from ..testcases import williamson_case6

TOLERANCE = {torch.float64: 5e-12, torch.float32: 1e-5}
DT = 30.0


def case6_inputs(nel: int, s: int, dtype, device, seed: int = 0):
    """(con, topology, x, y): constants, topology, and two case-6 states
    perturbed by 1e-3 relative seeded noise (x is the stage's a-term)."""
    geom = make_cubed_sphere_2d(nel, s)
    ops = make_dfr_operators(s)
    metric = make_metric_2d(geom)
    q = williamson_case6(geom)
    rng = np.random.default_rng(seed)
    x = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
    y = q * (1.0 + 1e-3 * rng.standard_normal(q.shape))
    con = swop.build_constants(ops, metric, nel, dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return con, CubedSphereTopology(geom), t(x), t(y)


def per_variable_max(a: torch.Tensor) -> torch.Tensor:
    return a.abs().reshape(3, -1).amax(dim=1)


def flux_divergence_scale(q: torch.Tensor, con) -> torch.Tensor:
    """Per-variable max of |inv_sqrtG * div(F)|, the pointwise-flux term
    of the RHS."""
    (sqrtg, h11, h12, h22, *_, invsg) = con.fields
    h, hu1, hu2 = q[0], q[1], q[2]
    u1, u2, hsq, half_g = hu1 / h, hu2 / h, h * h, 0.5 * GRAVITY
    fx = torch.stack([sqrtg * hu1, sqrtg * (hu1 * u1 + half_g * h11 * hsq),
                      sqrtg * (hu2 * u1 + half_g * h12 * hsq)])
    fy = torch.stack([sqrtg * hu2, sqrtg * (hu1 * u2 + half_g * h12 * hsq),
                      sqrtg * (hu2 * u2 + half_g * h22 * hsq)])
    return per_variable_max(invsg * (torch.cat([fx, fy], dim=-1) @ con.dd))


def _scaled(err: torch.Tensor, scale: torch.Tensor) -> float:
    return float((err.abs().reshape(3, -1).amax(dim=1) / scale).max())


def compare_sw_operator(nel: int, s: int, dtype, device="cuda", seed: int = 0):
    """Kernel against plain in every mode; returns one dict per mode with
    the scaled error ``err``, its tolerance ``tol`` and ``ok``."""
    con, topology, x, y = case6_inputs(nel, s, dtype, device, seed)
    halo = swop.halo_from_traces(swop.edge_traces(y, con), topology)
    modes = {
        "rhs": dict(),
        "stage": dict(a=0.0, b=1.0, cdt=DT),
        "stage_x": dict(x=x, a=0.75, b=0.25, cdt=0.25 * DT),
        "stage_x_traces": dict(x=x, a=1.0 / 3.0, b=2.0 / 3.0, cdt=(2.0 / 3.0) * DT, emit_traces=True),
    }
    tol = TOLERANCE[dtype]
    results = []
    for mode, kw in modes.items():
        got = swop.sw_operator(y, halo, con, **kw)
        want = swop.sw_operator_plain(y, halo, con, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        got_tr = want_tr = None
        if kw.get("emit_traces"):
            (got, got_tr), (want, want_tr) = got, want
        row = {"nel": nel, "s": s, "dtype": str(dtype).replace("torch.", ""), "mode": mode,
               "max_abs_err": float((got - want).abs().max())}
        row["err_of_output_max"] = _scaled(got - want, per_variable_max(want))
        if mode == "rhs" and dtype == torch.float32:
            row["scale"] = "flux_divergence_max"
            row["err"] = _scaled(got - want, flux_divergence_scale(y, con))
        else:
            row["scale"] = "output_max"
            row["err"] = row["err_of_output_max"]
        if got_tr is not None:
            row["traces_err"] = _scaled(got_tr - want_tr, per_variable_max(want_tr))
        row["tol"] = tol
        row["ok"] = bool(
            np.isfinite(row["err"]) and row["err"] <= tol
            and row.get("traces_err", 0.0) <= tol and torch.isfinite(got).all().item()
        )
        results.append(row)
    return results
