from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.models.fnn import make_fnn

__all__ = ["make_fnn", "transformer", "ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig"]
