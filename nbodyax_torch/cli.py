"""Command-line entry point.

``python -m nbodyax_torch.cli [--config nbodyConfig.txt] [--set key=value ...]
[--device cuda|cpu] [--profile DIR] [--debug-nans] [--resume CKPT|auto]``

The arguments of ``nbodyax.cli``, plus ``--device``, which defaults to
``cuda``: asking for CUDA without a card is an error, never a quiet switch
to the CPU. ``--profile DIR`` writes a ``torch.profiler`` trace of the step
loop to ``DIR/trace.json``. ``--debug-nans`` tests each window's state and
conservation vector for NaN and raises ``FloatingPointError`` naming the
first step and field that hold one (``run_simulation``'s ``debug_nans``;
``nbodyax``'s flag turns on ``jax_debug_nans``).
``--resume CKPT`` continues from a checkpoint file (written by either
package), ``--resume auto`` from the newest one in ``checkpointPath``.
With no ``nbodyConfig.txt`` in the working directory the built-in default
scene runs. Prints the settings and the reference's final ``Time taken:``
line.

``--set shards=P`` runs one process a shard under ``torch.distributed``:

    python -m torch.distributed.run --nproc-per-node P \
        -m nbodyax_torch.cli --set shards=P [--device cpu] ...

(NCCL on cards, one rank a card; gloo with ``--device cpu``). Rank 0
alone prints, logs and writes frames and checkpoints. With ``autoResume``
and ``checkpointEvery`` the launch also takes ``--max-restarts`` of at
least ``maxRetries``: a failure relaunches every rank, and the relaunched
ranks resume from the latest checkpoint. A failure that one card would not
retry (``--debug-nans``'s ``FloatingPointError``, a kernel build, a
``ValueError``) makes the relaunched ranks stop at once.
"""

from __future__ import annotations

import argparse
import os
import sys

from nbodyax_torch.config import SimConfig, apply_overrides, parse_config_file
from nbodyax_torch.driver import resolve_device, run_simulation
from nbodyax_torch.io.checkpoint import latest_checkpoint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nbodyax_torch",
        description="n-body simulation with collisions, 2-D or 3-D, "
        "PyTorch + CUDA")
    ap.add_argument("--config", default="nbodyConfig.txt",
                    help="config file (reference nbodyConfig.txt format)")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                    help="override a config key (repeatable)")
    ap.add_argument("--steps", type=int, default=None,
                    help="override totalIterations")
    ap.add_argument("--no-images", action="store_true",
                    help="skip frame rendering")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the step loop "
                         "to DIR/trace.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="test each window's state for NaN and raise "
                         "FloatingPointError at the first step that holds "
                         "one")
    ap.add_argument("--resume", default=None, metavar="CKPT",
                    help="resume from checkpoint file (or 'auto' for latest "
                         "in checkpointPath)")
    args = ap.parse_args(argv)
    # under torchrun only rank 0 speaks
    args.quiet = args.quiet or os.environ.get("RANK", "0") != "0"

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
        if not args.quiet:
            print("No nbodyConfig.txt found; running the built-in default "
                  "scene (pass --config or cd to the config's directory)",
                  file=sys.stderr)
        cfg = SimConfig()
    cfg = apply_overrides(cfg, args.set)
    if args.steps is not None:
        cfg.total_iterations = args.steps
    if args.no_images:
        cfg.save_images = False
    if args.resume == "auto":
        ck = latest_checkpoint(cfg.checkpoint_path)
        if ck is None:
            print(f"No checkpoint found in {cfg.checkpoint_path}",
                  file=sys.stderr)
            return 1
        cfg.resume_from = ck
    elif args.resume:
        cfg.resume_from = args.resume

    failed = True
    try:
        run_simulation(cfg, device=device, quiet=args.quiet,
                       profile_dir=args.profile, debug_nans=args.debug_nans)
        failed = False
    finally:
        from nbodyax_torch.sharding import close_group
        close_group(failed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
