"""The paper's analytical performance and energy model (a copy of the JAX
package's ``pimsim``):

  params -- Table 3 constants (AiM DRAM-PIM, SRAM-CIM macro, NoC, NLU, CXL,
            the A100 / HBM-PIM baseline)
  ops    -- per-substrate latency and energy models
  system -- CENT / CENT+Curry / CompAir base / CompAir opt / AttAcc proxy

Every number it gives prices the paper's modeled hardware, not the H100 the
port runs on.  The paper's figures are drawn from these by the JAX package's
``benchmarks/fig*.py``, which the port's own benchmark has yet to take up.
"""
from repro_torch.pimsim import ops, params, system  # noqa: F401
