"""``driver_device_ms_per_step``: device ms a job step of the kernels,
copies and sets launched under the driver's host-work spans
(``spans.HOST_WORK``): the probes' ``bh_health``, the captures' eager
warm-ups, compaction, energy, checkpoint copies, whatever their names.
With the replays' kernels, which the ``window`` span launches, it makes up
the traced job's device time. Steps are the traced job's. Reads the
record's ``launched`` (``perfbench/spans.py``), None without it. Layer:
driver windows."""

from perfbench.spans import HOST_WORK


def read(record):
    tr = record["trace"]
    if not tr or "launched" not in tr:
        return None
    ns = sum(e - s for _, s, e, span in tr["launched"] if span in HOST_WORK)
    return ns / 1e6 / tr["steps"]
