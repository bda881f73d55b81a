"""Kernels of the port: plain PyTorch versions (``ref``), hand-written CUDA
kernels for Hopper (``csrc/``, one wrapper module each) and the
device-dispatching API (``ops``).  Besides the serving and training paths'
kernels, ``ops`` carries the reference's fidelity entries, which no model
calls: ``matmul`` (the weight-stationary GEMM of ``matmul.py``, routed by
the reference's panel-size rule) and the Curry-ALU forms of ``rmsnorm`` and
``silu_mul`` (``curry_rounds``)."""
