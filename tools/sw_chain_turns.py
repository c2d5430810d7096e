"""The shallow-water main path's end-to-end rows of two checkouts, in turns
on one card: phases 3 (case 6, f64, nel=64, s=3, through the CLI) and 19
(the f32 perturbation points chained, the f32 s=4 CLI run) of each
checkout's own chip_smoke.py, run as parent, change, change, parent, each
in a process of its own (each checkout builds its own kernels into its
build/kernels/).

    python tools/sw_chain_turns.py PARENT_DIR CHANGE_DIR

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


def one(root: str, tag: str) -> dict:
    root = os.path.abspath(root)
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke

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
        print(json.dumps(one(argv[1], argv[2])), flush=True)
        return 0
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent, change = argv
    for tag, root in (("parent", parent), ("change", change), ("change", change), ("parent", parent)):
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root, tag]).returncode
        if rc != 0:
            return rc
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
