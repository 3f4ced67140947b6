"""Auxiliary tools of the port, under genfer_tpu's module names (reference:
src/bin/*.rs); each runs as ``python -m genfer_tpu_torch.tools.<name>``.

* ``stats``      - parse + support-analyze a program, print summary
* ``translate``  - compile SGCL to WebPPL or Anglican source
* ``baselines``  - emit the digitRecognition baselines (SGCL, PSI, Dice,
  Prodigy) from CSV parameter files
* ``generators`` - the benchmark model families (the port's copy of
  genfer_tpu's generators, so that a program made for the port reads the
  same as one made for genfer_tpu)
"""
