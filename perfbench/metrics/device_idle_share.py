"""``device_idle_share``: the share of the traced job's span (the
harness's ``perfbench.job`` span) in which no kernel, copy or set ran on
rank 0's card, in %. Layer: device."""


def read(record):
    tr = record["trace"]
    if not tr or not tr["device"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
