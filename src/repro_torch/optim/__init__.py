from repro_torch.optim.sgd import (
    MomentumState, adamw_init, adamw_update, decreasing_lr, momentum_init, momentum_sgd,
    momentum_update, sgd_update,
)

__all__ = ["decreasing_lr", "sgd_update", "MomentumState", "momentum_init", "momentum_sgd",
           "momentum_update", "adamw_init", "adamw_update"]
