"""Training of the port (the LM data-parallel path, in this slice)."""

from .lm import (create_lm_train_state, local_rows,  # noqa: F401
                 make_lm_eval_step, make_lm_train_step, to_device)
from .optim import SGD, cosine_lr, sgd  # noqa: F401
from .state import TrainState  # noqa: F401
