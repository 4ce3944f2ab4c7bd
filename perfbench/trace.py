"""Reduction of a ``torch.profiler`` trace to what the readers need.

``events(prof)`` splits the profiler's events into device activity
(kernels, copies, sets: what ran on the card) and host activity (ops,
runtime calls, the harness's spans), each as ``(name, start_ns, end_ns)``.
Kernel names are cut to their function's name (``pair_kernel`` for
``void pair_kernel<2, 0>(float const*, ...)``), which is how the readers
attribute time to the port's kernels.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

__all__ = ["events", "short_name", "busy_seconds", "idle_by_host",
           "top_device_ops", "family", "FAMILIES", "executed_steps",
           "family_seconds"]

# the port's hand-written kernels and NCCL's, by the functions' names
FAMILIES = {
    "B1": ("pair_kernel", "pair_combine"),
    "B2": ("pair_bwd_kernel", "pair_bwd_combine"),
    "B3": ("near_kernel",),
    "B4B5": ("slot_pack_kernel", "slot_pack_moments_chunk"),
}
_NCCL = re.compile(r"^nccl", re.IGNORECASE)
SPAN_PREFIX = "perfbench."  # the harness's own spans (record_function)
SHORT_GAP_NS = 20_000        # a gap this short is the launch pipeline's
LONG_EVENT_NS = 50_000_000   # host events this long are searched apart


def short_name(name: str) -> str:
    """A kernel's function name without its return type, template
    arguments and parameters; other names as they are."""
    s = name.strip().replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for cut in ("<", "("):
        i = s.find(cut)
        if i > 0:
            s = s[:i]
    return s.rsplit("::", 1)[-1].strip()[:120]


def family(name: str):
    """``B1``..``B4B5``, ``NCCL`` or None for a device event's short
    name."""
    for fam, names in FAMILIES.items():
        if name in names:
            return fam
    if _NCCL.match(name):
        return "NCCL"
    return None


def events(prof):
    """``(device, host)``: lists of ``(name, start_ns, end_ns)`` of the
    profiler ``prof`` after it stopped, device names shortened."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if not str(e.device_type()).upper().endswith("CUDA"):
            host.append((e.name(), start, end))
        elif not e.name().startswith(SPAN_PREFIX):
            # (a harness span's copy on the card's timeline is no activity)
            device.append((short_name(e.name()), start, end))
    device.sort(key=lambda t: t[1])
    return device, host


def _union(intervals):
    """Merged, sorted intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_seconds(device, t0: int, t1: int) -> float:
    """Seconds of [t0, t1] (ns) in which some device activity ran."""
    busy = _union((max(s, t0), min(e, t1)) for _, s, e in device
                  if e > t0 and s < t1)
    return sum(e - s for s, e in busy) / 1e9


def _gaps(device, t0: int, t1: int):
    busy = _union((max(s, t0), min(e, t1)) for _, s, e in device
                  if e > t0 and s < t1)
    edge = t0
    for s, e in busy:
        if s > edge:
            yield edge, s
        edge = max(edge, e)
    if t1 > edge:
        yield edge, t1


def idle_by_host(device, host, t0: int, t1: int, top: int = 10):
    """The device's idle time in [t0, t1], summed by what the host was
    doing: for each gap, the most specific host event that covers half of
    it or more (else the one that covers most of it). Gaps under
    ``SHORT_GAP_NS`` between kernels are summed as one entry. The ``top``
    largest, as ``[[name, seconds], ...]``."""
    long_ = [h for h in host if h[2] - h[1] > LONG_EVENT_NS]
    short = sorted((h for h in host if h[2] - h[1] <= LONG_EVENT_NS),
                   key=lambda t: t[1])
    starts = [h[1] for h in short]
    out = defaultdict(float)
    for gs, ge in _gaps(device, t0, t1):
        if ge - gs < SHORT_GAP_NS:
            out[f"between kernels (gaps < {SHORT_GAP_NS // 1000} us)"] += (
                (ge - gs) / 1e9)
            continue
        lo = bisect.bisect_left(starts, gs - LONG_EVENT_NS)
        hi = bisect.bisect_right(starts, ge)
        best, best_key = "host (no event)", None
        for name, s, e in short[lo:hi] + long_:
            cover = min(e, ge) - max(s, gs)
            if cover <= 0:
                continue
            key = ((0, e - s) if 2 * cover >= ge - gs else (1, -cover))
            if best_key is None or key < best_key:
                best, best_key = name, key
        out[best] += (ge - gs) / 1e9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            [:top]]


def top_device_ops(device, top: int = 10):
    """Device seconds by name, the ``top`` largest."""
    out = defaultdict(float)
    for name, s, e in device:
        out[name] += (e - s) / 1e9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])
            [:top]]


def family_seconds(device, fam) -> float:
    """Device seconds of the kernels of family ``fam`` (None: every
    kernel of no family)."""
    return sum(e - s for name, s, e in device if family(name) == fam) / 1e9


def executed_steps(record) -> float:
    """Steps the traced job ran on the device, its captures' eager warm-up
    steps included: launches of the step's own kernel, B3 on the bh path
    (one a step), else B1 over the shard count (one a ring hop), else the
    job's steps."""
    device = record["trace"]["device"]
    b3 = sum(1 for name, _, _ in device if name == "near_kernel")
    if b3:
        return float(b3)
    b1 = sum(1 for name, _, _ in device if name == "pair_kernel")
    if b1:
        return b1 / record["shards"]
    return float(record["trace"]["steps"])
