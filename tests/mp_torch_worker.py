"""Worker of tests/test_torch_distributed.py: one rank of a multi-process
run of the PyTorch port on the CPU, joined over gloo.

Usage: python tests/mp_torch_worker.py cli <port> <num_procs> <rank> <config_path>
       python tests/mp_torch_worker.py sharded <port> <num_procs> <rank> <out_dir>

``cli`` runs the port's real entry point (``python -m wxfactory_tpu_torch
config.ini --device cpu --coordinator ... --num-processes ... --process-id
...``). ``sharded`` writes a tile-parallel state through
``save_state_distributed`` in its sharded form (manifest and one shard a
tile), reads it back with ``load_state_distributed`` on every rank and
exits 0 when the round trip is exact.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sharded(port: str, nproc: int, rank: int, out_dir: str) -> int:
    import numpy as np
    import torch

    from types import SimpleNamespace

    from wxfactory_tpu_torch.parallel import TileMesh
    from wxfactory_tpu_torch.parallel.distributed import (
        init_distributed,
        load_state_distributed,
        save_state_distributed,
        shutdown,
    )

    init_distributed(f"localhost:{port}", nproc, rank, device="cpu")
    full = np.random.default_rng(11).standard_normal((5, 6, 2, 4, 4, 8))
    mesh = TileMesh(1, rank, nproc)
    q = torch.as_tensor(full)  # each rank writes only the tiles it owns
    path = os.path.join(out_dir, "state_vector_sharded.00000001.npy")
    config = SimpleNamespace(raw_text="[General]\nequations = euler\n")  # the manifest keeps its text
    save_state_distributed(q, mesh, config, path, small_bytes=0)
    with open(path, "rb") as fh:
        manifest = fh.read(1) == b"{"
    state, text = load_state_distributed(path)
    ok = manifest and np.array_equal(state, full) and "euler" in text
    shutdown()
    return 0 if ok else 1


def main() -> int:
    mode, port, nproc, rank, arg = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    if mode == "sharded":
        return sharded(port, nproc, rank, arg)
    from wxfactory_tpu_torch.__main__ import main as cli_main

    return cli_main([arg, "--device", "cpu", "--coordinator", f"localhost:{port}", "--num-processes", str(nproc),
                     "--process-id", str(rank), "--show-every-crash"])


if __name__ == "__main__":
    sys.exit(main())
