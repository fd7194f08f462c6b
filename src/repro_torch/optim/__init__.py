from repro_torch.optim.sgd import decreasing_lr

__all__ = ["decreasing_lr"]
