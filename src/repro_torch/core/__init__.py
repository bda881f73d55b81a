"""The paper's primary contribution, as far as the port carries it:

  curry — Curry-ALU iterated non-linears (Taylor exp, Newton rsqrt)
  noc   — the in-transit softmax combine of sequence-sharded attention
          partials, and its hop/energy cost model

Torch copies of the JAX package's ``core.curry`` and of the serving parts of
``core.noc`` (the port imports nothing of ``repro``).  ``isa``, ``mapping``,
``planner`` and ``noc``'s other cost arms come with later slices.
"""
from repro_torch.core import curry  # noqa: F401
from repro_torch.core import noc  # noqa: F401
