"""The check that a run loaded nothing of the JAX package or of JAX.

Module names are compared by their top-level part (before the first dot),
whole: ``nbodyax_torch`` begins with ``nbodyax`` but is not it.
"""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "forbidden_loaded"]

# JAX and what rides on it, the JAX package, and its benchmark scripts
# (``bench/`` and the root ``bench.py``, both top-level ``bench``)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nbodyax", "bench"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's ``sys.modules``), sorted."""
    names = {str(m).split(".", 1)[0]
             for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)
