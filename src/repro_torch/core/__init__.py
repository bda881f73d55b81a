"""The paper's primary contribution, in the port:

  curry   -- Curry-ALU iterated non-linears (Taylor exp, Newton rsqrt)
  isa     -- the hierarchical ISA of §5: row-level programs lowered to
             packet plans by path generation, and a bank-major machine that
             runs them on torch buffers on any device
  noc     -- the in-transit collectives (butterfly, reduce / broadcast
             trees, the sharded softmax and the centralized-NLU baselines)
             over a list of shards, the softmax combine of sequence-sharded
             attention partials, and the NoC, preemption, handoff and
             expert-placement cost models (the paper's CXL and PIM rates)
  planner -- the substrate-selection lanes on the card's roofline
  mapping -- the §3.3 output-split vs input-split cost model and the
             sharding plan over a mesh of ``launch/mesh.py``

Torch copies of the JAX package's ``core`` modules (the port imports
nothing of ``repro``).  ``shardhints`` has no counterpart on one card.
"""
from repro_torch.core import curry  # noqa: F401
from repro_torch.core import isa  # noqa: F401
from repro_torch.core import mapping  # noqa: F401
from repro_torch.core import noc  # noqa: F401
from repro_torch.core import planner  # noqa: F401
