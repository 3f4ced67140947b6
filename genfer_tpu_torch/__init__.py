"""genfer_tpu_torch: the PyTorch / CUDA port of genfer_tpu for NVIDIA Hopper.

The port sits beside the JAX package, which stays the reference.  It
imports genfer_tpu's framework-free layers (``lang``, ``semantics``,
``gf``, ``numbers``, ``taylor.tensorpoly``, ``tools``, the native C++
extensions and the CLI's parser and printer) and re-implements only the
code that calls jax, under the same module names:

* ``genfer_tpu_torch.taylor.backend`` - torch device helpers and the
  host-offload ``HybridBackend`` / ``PallasBackend``
* ``genfer_tpu_torch.ops.conv2d``     - the truncated 2-D Cauchy product
  in f32, a hand-written CUDA kernel for ``sm_90a``
  (``csrc/conv2d_trunc_f32.cu``) beside its plain PyTorch version
* ``genfer_tpu_torch._build``         - compiles ``csrc/*.cu`` with nvcc on
  first use and loads the library with ctypes
* ``genfer_tpu_torch.cli``            - ``python -m genfer_tpu_torch``
* ``genfer_tpu_torch.tools.generators`` - genfer_tpu's model-family
  generators, under the port's name

This package never imports jax.
"""

__version__ = "0.1.0"
