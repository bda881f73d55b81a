"""Kernels of the port: plain PyTorch versions (``ref``), hand-written CUDA
kernels for Hopper (``csrc/``, one wrapper module each) and the
device-dispatching API (``ops``)."""
