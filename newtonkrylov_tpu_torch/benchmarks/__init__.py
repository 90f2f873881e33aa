"""Measuring scripts of the port, run on the card with ``python -m``.

* :mod:`.kernel_probe` — the chained-step cost probe (K6), counterpart of
  the JAX probe ``benchmarks/kernel_probe.py``.
"""
