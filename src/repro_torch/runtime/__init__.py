"""Training runtime of the port: the fault-tolerant driver and the
straggler detector (elastic rescale comes with the sharding slice)."""
from repro_torch.runtime import driver, straggler  # noqa: F401
from repro_torch.runtime.driver import SimulatedFailure, TrainDriver  # noqa: F401
from repro_torch.runtime.straggler import StragglerDetector  # noqa: F401
