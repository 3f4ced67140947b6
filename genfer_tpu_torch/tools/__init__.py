"""Auxiliary tools of the port, under genfer_tpu's module names.

* ``generators`` - the benchmark model families (genfer_tpu's own
  generators; they are framework-free and load no jax)
"""
