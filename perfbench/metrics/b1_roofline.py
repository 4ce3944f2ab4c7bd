"""``b1_roofline``: the share of its FP32 bound at which the pair kernel B1
(``pair_kernel`` and ``pair_combine``, ``csrc/pair_kernel.cu``) ran in the
traced job, in %.

Work counts live pairs only: dead bodies are no work, whatever the kernel
does with them. A pair costs 18 FP32 flops in 2-D and 23 in 3-D
(``csrc/pair_kernel.cu:28-33``). The bound is those flops at the card's
published FP32 peak (``peaks.py``; 67 TFLOP/s for an H100 at 700 W, the
run prints the card's own limit), and the share is that bound over B1's
device time. A step's live count is the next log point's ``alive`` (the
job's final count after the last one): the fewest bodies the step can
have had, so the share never overstates. On a ring, rank 0's work is its
own live rows against every live body, its rows counted at the job's end.
The captures' eager warm-up steps run B1 too: each counts the job's final
live bodies.
"""

from perfbench.peaks import peak

FLOPS_PER_PAIR = {2: 18, 3: 23}


def read(record):
    tr = record["trace"]
    if not tr:
        return None
    device = tr["device"]
    launches = sum(1 for name, _, _ in device if name == "pair_kernel")
    if not launches:
        return None
    seconds = sum(e - s for name, s, e in device
                  if name in ("pair_kernel", "pair_combine")) / 1e9
    shards = record["shards"]
    final = tr["final_alive"]
    rows_final = tr["rows_alive"]
    points = sorted((int(p["step"]), int(p["alive"])) for p in tr["log"]
                    if "alive" in p)

    def live_after(step):
        for at, alive in points:
            if at >= step:
                return alive
        return final

    def pairs(cols):
        rows = cols if shards == 1 else rows_final
        return rows * max(cols - 1, 0)

    total = sum(pairs(live_after(s)) for s in range(1, tr["steps"] + 1))
    total += max(launches / shards - tr["steps"], 0) * pairs(final)
    dim = int(record["params"].get("dimensions", 2))
    flops = total * FLOPS_PER_PAIR[dim]
    return 100.0 * flops / peak(record["kind"], "fp32_flops") / seconds
