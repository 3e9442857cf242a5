from repro_torch.train.loss import lm_loss  # noqa: F401
from repro_torch.train.step import (  # noqa: F401
    TrainState,
    apply_update,
    init_train_state,
    make_decode_step,
    make_grad_fn,
    make_prefill_step,
    make_train_step,
    train_state_from_numpy,
)
