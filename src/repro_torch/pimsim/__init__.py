"""The paper's hardware constants, as far as the port's cost models read
them: ``params`` (a copy of the JAX package's ``pimsim/params.py`` classes
``DramPim``, ``SramPim`` and ``Cxl``).  The analytical latency and energy
models (``pimsim.ops``, ``pimsim.system``) come with the tooling slice."""
from repro_torch.pimsim import params  # noqa: F401
