"""Training on one device: TrainState, the step factory, microbatching
(port of ``repro.train``)."""
from repro_torch.train.state import (init_train_state,  # noqa: F401
                                     state_shardings)
from repro_torch.train.step import (TrainConfig, init_full_state,  # noqa: F401
                                    jit_train_step, make_train_step)
