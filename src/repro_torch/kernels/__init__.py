"""Hand-written Hopper kernels of the port, their plain PyTorch versions,
and the wrappers that choose between them.

Each wrapper takes its kernel's plain version only for a tensor that lies
on the CPU; for a CUDA tensor it launches the kernel or raises.  Sources
live in ``csrc/`` and are built at first use by ``_build``.
"""
