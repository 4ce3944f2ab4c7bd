"""``other_device_ms_per_step``: device ms a step in kernels other than
the port's hand-written ones (B1-B5) and NCCL's: the step tail and the bh
structure in plain torch (``physics/step.py``, ``collisions.py``,
``barneshut.py``, ``bh_grid.py``, ``fmm.py``), copies and sets. Steps
are the traced job's executed steps (``trace.executed_steps``). Layer:
step tail and bh structure in plain torch."""

from perfbench.trace import executed_steps, family_seconds


def read(record):
    tr = record["trace"]
    if not tr or not tr["device"]:
        return None
    return 1e3 * family_seconds(tr["device"], None) / executed_steps(record)
