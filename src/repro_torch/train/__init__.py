"""Training of the port: AdamW (``optim``), the train step (``step``) and
the int8-compressed gradient sync with error feedback (``compress``)."""
from repro_torch.train import compress, optim, step  # noqa: F401
from repro_torch.train.step import TrainState, init_state, make_train_step  # noqa: F401
