"""``driver_wait_ms_per_step``: ms a job step in which nothing ran on rank
0's card while the innermost program span on the host was one of the
driver's host-work spans (``spans.HOST_WORK``: ``capture``, ``probe``,
``runner``, ``graph_free``, ``knobs``, ``log``, ``checkpoint``,
``compaction``, ``frames``, ``scene``); the window's own launch and fetch
are not counted. Steps are the traced job's. Reads the record's ``spans``
and ``launched`` (``perfbench/spans.py``), None without them. Layer: driver
windows."""

from perfbench.spans import HOST_WORK, idle_by_span


def read(record):
    tr = record["trace"]
    if not tr or not tr.get("spans") or "launched" not in tr:
        return None
    idle = idle_by_span(tr["launched"], tr["spans"])
    return 1e3 * sum(v for k, v in idle.items() if k in HOST_WORK) / (
        tr["steps"])
