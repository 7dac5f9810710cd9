"""Training of the port: the image and LM data-parallel steps, the
optimizer, the train state, the image trainer and checkpoints."""

from .lm import (create_lm_train_state, local_rows,  # noqa: F401
                 make_lm_eval_step, make_lm_eval_step_tp,
                 make_lm_train_step, make_lm_train_step_tp, to_device)
from .lamb import Lamb, lamb  # noqa: F401
from .optim import SGD, cosine_lr, multistep_lr, sgd, sgd_fused  # noqa: F401
from .state import TrainState  # noqa: F401
from .step import (create_train_state, make_eval_step,  # noqa: F401
                   make_train_step)
