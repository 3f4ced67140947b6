"""Auxiliary tools of the port, under genfer_tpu's module names.

* ``generators`` - the benchmark model families (the port's copy of
  genfer_tpu's generators, so that a program made for the port reads the
  same as one made for genfer_tpu)
"""
