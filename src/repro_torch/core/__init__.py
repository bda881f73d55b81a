"""The paper's primary contribution, as far as the port carries it:

  curry — Curry-ALU iterated non-linears (Taylor exp, Newton rsqrt)

A torch copy of the JAX package's ``core.curry`` (the port imports nothing
of ``repro``).  ``isa``, ``mapping``, ``planner`` and ``noc`` come with later
slices.
"""
from repro_torch.core import curry  # noqa: F401
