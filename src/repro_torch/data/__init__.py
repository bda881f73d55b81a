"""Training data of the port: the deterministic synthetic pipeline."""
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, for_cell  # noqa: F401
