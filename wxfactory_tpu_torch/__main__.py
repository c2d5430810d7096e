"""Command-line entry point: ``python -m wxfactory_tpu_torch config.ini --device cuda``.

Counterpart of ``wxfactory_tpu/__main__.py``: run a simulation from an INI
file, or dump the option reference with --config-options.
"""

import argparse
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
    args = parser.parse_args(argv)

    if args.config_options:
        from .config import schema_documentation

        print(schema_documentation())
        return 0
    if not args.config:
        parser.error("a configuration file is required (or use --config-options)")

    from .simulation import Simulation

    try:
        Simulation(args.config, device=args.device).run()
    except Exception:
        import traceback

        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
