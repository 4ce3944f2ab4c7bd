"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM (NVIDIA's data sheet; dense rates, without sparsity), at
the full 700 W power limit. A run prints the card's own limit beside
every share of these (``card_line``).
"""

from __future__ import annotations

import subprocess

__all__ = ["PEAKS", "peak", "card_line"]

PEAKS = {"H100": {"fp32_flops": 67e12}}


def peak(kind: str, what: str) -> float:
    """The peak ``what`` of the card named ``kind``
    (``torch.cuda.get_device_name``)."""
    for key, table in PEAKS.items():
        if key in kind:
            return table[what]
    raise KeyError(f"no published peaks for {kind!r}")


def card_line(index: int = 0, fields: str = "name,power.limit") -> str:
    """The card's ``fields`` as ``nvidia-smi`` prints them: by default its
    name and power limit."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}", f"--query-gpu={fields}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
