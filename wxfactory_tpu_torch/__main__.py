"""Command-line entry point: ``python -m wxfactory_tpu_torch config.ini --device cuda``.

Counterpart of ``wxfactory_tpu/__main__.py``: run a simulation from an INI
file, or dump the option reference with --config-options.

A run over several processes (the reference's ``mpirun -n 6N^2``) starts
one process a rank, either with the JAX CLI's flags on every process
(``--coordinator HOST:PORT --num-processes N --process-id I``) or under
torchrun (``torchrun --nproc-per-node N -m wxfactory_tpu_torch cfg.ini``,
which sets WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT).
Rank r runs on ``cuda:(local rank % cards)``; ranks that share a card
exchange halos over gloo, staged through host memory.
"""

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="wxfactory_tpu_torch", description="Cubed-sphere dynamical core on PyTorch/CUDA"
    )
    parser.add_argument("config", nargs="?", help="Path to the simulation configuration (INI)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: cuda (default), cuda:N or cpu")
    parser.add_argument(
        "--config-options", action="store_true", help="Print every available configuration option and exit"
    )
    parser.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                        help="address of rank 0's rendezvous for a multi-process run")
    parser.add_argument("--num-processes", type=int, default=None, help="total number of processes (ranks)")
    parser.add_argument("--process-id", type=int, default=None, help="this process's rank in [0, num-processes)")
    parser.add_argument("--show-every-crash", action="store_true",
                        help="print the traceback of a failure on every rank, not only on rank 0")
    args = parser.parse_args(argv)

    if args.config_options:
        from .config import schema_documentation

        print(schema_documentation())
        return 0
    if not args.config:
        parser.error("a configuration file is required (or use --config-options)")

    from .parallel import distributed

    device = args.device
    world = args.num_processes if args.num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        _, _, local_rank = distributed.init_distributed(args.coordinator, args.num_processes, args.process_id,
                                                        device=device)
        if device == "cuda":
            import torch

            device = f"cuda:{local_rank % torch.cuda.device_count()}"

    from .simulation import Simulation

    try:
        Simulation(args.config, device=device).run()
    except Exception:
        if args.show_every_crash or distributed.is_primary():
            import traceback

            traceback.print_exc()
        distributed.shutdown(clean=False)
        return 1
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
