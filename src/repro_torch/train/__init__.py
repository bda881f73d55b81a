"""Training of the port: AdamW (``optim``) and the train step (``step``)."""
from repro_torch.train import optim, step  # noqa: F401
from repro_torch.train.step import TrainState, init_state, make_train_step  # noqa: F401
