"""Training runtime of the port: the fault-tolerant driver, the straggler
detector and the elastic rescale between meshes."""
from repro_torch.runtime import driver, elastic, straggler  # noqa: F401
from repro_torch.runtime.driver import SimulatedFailure, TrainDriver  # noqa: F401
from repro_torch.runtime.straggler import StragglerDetector  # noqa: F401
