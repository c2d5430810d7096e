"""The shallow-water main path's end-to-end rows of two checkouts, in turns
on one card: phases 3 (case 6, f64, nel=64, s=3, through the CLI) and 19
(the f32 perturbation points chained, the f32 s=4 CLI run) of each
checkout's own chip_smoke.py, run as parent, change, change, parent, each
in a process of its own (each checkout builds its own kernels into its
build/kernels/). With ``--epi``, phase 30's four exponential and
Rosenbrock runs on the card instead (SW_EPI_RUNS through the CLI's call,
each run once to warm up and once read: steps/s a run); with ``--jv``, the
host's cost of one Jacobian action through the model
(``ShallowWaterRHS.jtv_apply`` of one ``jtv_prep``, case 6, float64, s=3,
nel = 10 and 30): the host clock a call over 500 calls enqueued without a
wait (``enqueue_us``) and over 500 calls each followed by a synchronize
(``synced_us``, what a Krylov iteration that reads its result back pays),
beside the same two of the operator's RHS call, whose code both trees
share; in ``--turns`` rounds of parent, change, change, parent.

    python tools/sw_chain_turns.py [--epi | --jv] [--turns N] PARENT_DIR CHANGE_DIR

On the machine with the card; PARENT_DIR and CHANGE_DIR are roots of
checkouts (e.g. ``git archive REV`` unpacked into a git-ignored
directory). Prints one JSON line a run: phase 3's steps/s and, per phase
19 point, chained steps/s, the device's busy and span shares, device
operations a step and packed_run steps/s, and the CLI run's steps/s; then
the card's name and power limit.
"""

import contextlib
import io
import json
import os
import subprocess
import sys


def _host_us(torch, fn, n=500):
    """(enqueue_us, synced_us) of ``fn`` on the host clock."""
    import time

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    return enqueue, (time.perf_counter() - t0) / n * 1e6


def jv_costs(torch) -> dict:
    """The ``--jv`` rows of the checkout on sys.path."""
    import numpy as np

    from wxfactory_tpu_torch.kernels import check
    from wxfactory_tpu_torch.models.shallow_water import ShallowWaterRHS

    rows = {}
    for nel in (10, 30):
        geom, ops, metric, topology, q0 = check.sw_setup(nel, 3)
        rhs = ShallowWaterRHS(geom, ops, metric, topology=topology)
        q = torch.as_tensor(q0, device="cuda")
        scale = 1e-3 * np.abs(q0).reshape(3, -1).max(axis=1).reshape(3, 1, 1, 1, 1)
        v = torch.as_tensor(scale * np.random.default_rng(7).standard_normal(q0.shape), device="cuda")
        prep = rhs.jtv_prep(q)
        jv = _host_us(torch, lambda: rhs.jtv_apply(prep, v))
        op = _host_us(torch, lambda: rhs(q))
        rows[f"nel={nel}"] = {"jv_enqueue_us": jv[0], "jv_synced_us": jv[1], "rhs_enqueue_us": op[0],
                              "rhs_synced_us": op[1]}
    return rows


def one(root: str, tag: str, epi: bool = False, jv: bool = False) -> dict:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke

    if jv:
        return {"tree": tag, "jv": jv_costs(torch)}

    if epi:
        out = {"tree": tag, "phase30_steps_per_s": {}}
        for read in (False, True):
            for run in chip_smoke.SW_EPI_RUNS:
                with contextlib.redirect_stdout(io.StringIO()):
                    row, _ = chip_smoke._sw_epi_run(torch, *run)
                if read:
                    out["phase30_steps_per_s"][run[0]] = row["steps_per_s"]
        return out

    with contextlib.redirect_stdout(io.StringIO()):
        chip_smoke.phase3(torch)  # first launches (library load) outside the read run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        chip_smoke.phase3(torch)
        chip_smoke.phase19(torch)
    out = {"tree": tag}
    keys = ("nel", "s", "chained_steps_per_s", "chained_device_busy_share", "chained_device_span_share",
            "chained_device_ops_per_step", "packed_run_steps_per_s")
    for line in buf.getvalue().splitlines():
        if not line.startswith("{"):
            continue
        d = json.loads(line)
        if d.get("phase") == 3:
            out["phase3_steps_per_s"] = d["steps_per_s"]
        elif d.get("phase") == 19:
            out["phase19"] = [{k: r.get(k) for k in keys} for r in d["results"]]
            out["phase19_cli_steps_per_s"] = d["simulation"]["steps_per_s"]
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--one":
        print(json.dumps(one(argv[1], argv[2], epi="--epi" in argv[3:], jv="--jv" in argv[3:])), flush=True)
        return 0
    mode = [a for a in argv if a in ("--epi", "--jv")]
    argv = [a for a in argv if a not in ("--epi", "--jv")]
    turns = 1
    if "--turns" in argv:
        i = argv.index("--turns")
        turns = int(argv[i + 1])
        argv = argv[:i] + argv[i + 2:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv
    for tag, root in (("parent", parent), ("change", change), ("change", change), ("parent", parent)) * turns:
        cmd = [sys.executable, os.path.abspath(__file__), "--one", root, tag] + mode
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            return rc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
