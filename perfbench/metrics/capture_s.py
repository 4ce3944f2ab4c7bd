"""``capture_s``: seconds a job spends warming up and capturing its CUDA
graphs (``RunResult.seconds["capture"]``, the driver's own host clock),
the mean over the window's jobs. Layer: driver windows."""


def read(record):
    jobs = record["jobs"]
    if not jobs:
        return None
    return sum(j["seconds"]["capture"] for j in jobs) / len(jobs)
