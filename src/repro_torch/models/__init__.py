from repro_torch.models.fnn import make_fnn

__all__ = ["make_fnn"]
