"""``b3_ms_per_step``: device ms of the bh near kernel B3
(``near_kernel``, ``csrc/near_kernel.cu``) a step: its mean launch, one a
bh step. Layer: near kernel B3."""

from perfbench.trace import family_seconds


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    launches = sum(1 for name, _, _ in tr["device"] if name == "near_kernel")
    if not launches:
        return None
    return 1e3 * family_seconds(tr["device"], "B3") / launches
