"""Command-line entry point.

``python -m nbodyax_torch.cli [--config nbodyConfig.txt] [--set key=value ...]
[--device cuda|cpu]``

The arguments of ``nbodyax.cli`` (less ``--profile``, ``--debug-nans`` and
``--resume``), plus ``--device``, which defaults to ``cuda``: asking for
CUDA without a card is an error, never a quiet switch to the CPU. With no
``nbodyConfig.txt`` in the working directory the built-in default scene runs.
Prints the settings and the reference's final ``Time taken:`` line.
"""

from __future__ import annotations

import argparse
import os
import sys

from nbodyax_torch.config import SimConfig, apply_overrides, parse_config_file
from nbodyax_torch.driver import resolve_device, run_simulation


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nbodyax_torch",
        description="n-body simulation with collisions (2-D, or 3-D with "
        "forceModel=exact), PyTorch + CUDA")
    ap.add_argument("--config", default="nbodyConfig.txt",
                    help="config file (reference nbodyConfig.txt format)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (repeatable)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override totalIterations")
    ap.add_argument("--no-images", action="store_true",
                    help="skip frame rendering")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"Error: {e} (pass --device cpu to run on the CPU)",
              file=sys.stderr)
        return 1

    if os.path.exists(args.config):
        if not args.quiet:
            print("Running simulation with the following settings:")
        cfg = parse_config_file(args.config, verbose=not args.quiet)
        if not args.quiet:
            print("=====================")
    else:
        if args.config != "nbodyConfig.txt":
            print(f"Error opening config file! ({args.config})",
                  file=sys.stderr)
            return 1
        print("No nbodyConfig.txt found; running the built-in default scene "
              "(pass --config or cd to the config's directory)",
              file=sys.stderr)
        cfg = SimConfig()
    cfg = apply_overrides(cfg, args.set)
    if args.steps is not None:
        cfg.total_iterations = args.steps
    if args.no_images:
        cfg.save_images = False

    run_simulation(cfg, device=device, quiet=args.quiet)
    return 0


if __name__ == "__main__":
    sys.exit(main())
