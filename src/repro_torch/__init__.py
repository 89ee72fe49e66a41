"""PyTorch/CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``src/repro``) stays the reference; this package imports
nothing from it and nothing of JAX.  Its kernels are CUDA C++ written for
Hopper (``kernels/csrc``), built from the package's own sources at first
use.  Entry points run on the card unless the caller asks for the CPU.
"""
