"""``probe_ms_per_step``: host ms a step in the bh probe (``bh_health`` and
the adapt ladder): the self time of the program's ``probe`` span
(``RunResult.seconds["probe"]``, the driver's own host clock) over the
steps of the window's jobs. None where the program keeps no such span.
Layer: driver windows."""


def read(record):
    jobs = [j for j in record["jobs"] if "probe" in j["seconds"]]
    if not jobs:
        return None
    return 1e3 * sum(j["seconds"]["probe"] for j in jobs) / sum(
        j["steps"] for j in jobs)
