"""The benchmark of ``nbodyax_torch``: one run of one cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cells, configurations and metrics are
named in ``BENCHMARK.json``; ``worker.py`` says what a run does. The last
line of standard output is the result, one JSON object; the last lines of
standard error are the numbers the check compared, each beside its limit.

A run needs CUDA and as many cards as the cell asks for, and exits with a
code other than 0, printing no result, without them, when the check cannot
run, or when JAX or the JAX package was loaded. A cell on several cards
runs under ``torch.distributed.run``, one process a card; rank 0 writes
the result, which this process prints. Kernel and build caches stay in
fixed directories inside the checkout.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# a run's own limit, under the 360 s a run is given
RUN_TIMEOUT_S = 340


def cache_env() -> None:
    """Every cache a run may fill, at fixed paths inside the checkout (the
    program's own kernels build into ``build/nbodyax_torch/``)."""
    cache = ROOT / "build" / "perfbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _across_cards(args, chips: int) -> dict:
    """The cell under ``torch.distributed.run``, one process a card."""
    out_dir = tempfile.mkdtemp(prefix="perfbench-result-",
                               dir=os.environ.get("TMPDIR"))
    out = os.path.join(out_dir, "result.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(chips), "-m", "perfbench.worker",
           "--workload", args.workload, "--seed", str(args.seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--t-start", repr(T_START), "--out", out]
    try:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=sys.stderr)
        try:
            rc = proc.wait(timeout=RUN_TIMEOUT_S - (time.time() - T_START))
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            raise RuntimeError("the ranks ran past the run's time limit")
        if rc != 0 or not os.path.exists(out):
            raise RuntimeError(f"the ranks failed (exit code {rc})")
        with open(out) as f:
            return json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    from perfbench.spec import load_cell
    cell = load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device; the benchmark runs on a card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if cell.chips > 1:
        out = _across_cards(args, cell.chips)
    else:
        from perfbench.worker import run_cell
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       t_start=T_START, device=torch.device("cuda", 0))
    from perfbench.guard import forbidden_loaded
    found = sorted(set(out.get("forbidden", [])) | set(forbidden_loaded()))
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}: the benchmark "
              "measures nbodyax_torch alone", file=sys.stderr)
        return 3
    for line in out["compared"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
