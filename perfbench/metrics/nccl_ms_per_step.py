"""``nccl_ms_per_step``: device ms a step in NCCL's kernels (names that
begin with ``nccl``) on rank 0: the ring's shifts and the window's
gathers. Layer: sharding."""

from perfbench.trace import executed_steps, family_seconds


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    t = family_seconds(tr["device"], "NCCL")
    if t <= 0:
        return None
    return 1e3 * t / executed_steps(record)
