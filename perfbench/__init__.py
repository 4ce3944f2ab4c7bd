"""The benchmark of ``nbodyax_torch``: ``python3 -m perfbench.run``.

Every cell, configuration and metric is named in ``BENCHMARK.json`` and
lives in files of its own here, found by name: ``cells/``, ``configs/``,
``scenes/`` (the start states' draws), ``reference/`` (each
configuration's plain step), ``end_to_end/`` and ``metrics/`` (the
readers). ``run.py`` and ``worker.py`` say what a run does, ``check.py``
how ``correct`` is decided. It imports nothing of JAX or of the JAX
package ``nbodyax``.
"""
