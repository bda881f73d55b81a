"""PyTorch/CUDA port of the CompAir serving stack for one NVIDIA H100.

A package of its own beside the JAX reference package ``repro``: it imports
``torch`` and never ``jax`` or anything of ``repro``.  Its structure mirrors
the JAX package (``configs``, ``core``, ``kernels``, ``models``, ``serve``,
``train``, ``launch``), and every Pallas TPU kernel of the JAX package has
a hand-written CUDA kernel for Hopper here (``kernels/csrc``).
"""
