"""Step factories and the optimizer of the port."""
from .optimizer import AdamWConfig, adamw_update, init_opt_state, \
    lr_schedule  # noqa: F401
from .steps import (  # noqa: F401
    cross_entropy,
    init_train_state,
    loss_fn,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)
