"""``window_steps_per_s``: the steps of the window's jobs over the device
time of their windows (``RunResult.steps_per_sec``: CUDA events around
each of the driver's windows). Its gap to ``steps_per_s`` is the host's
share: captures, probes, checkpoints, compaction, start and end of a job.
Layer: driver windows."""


def read(record):
    jobs = [j for j in record["jobs"] if j["steps_per_sec"] > 0]
    if not jobs:
        return None
    seconds = sum(j["steps"] / j["steps_per_sec"] for j in jobs)
    return sum(j["steps"] for j in jobs) / seconds
