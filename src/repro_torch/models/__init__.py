from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig, MLAConfig, MoEConfig, SSMConfig
from repro_torch.models.fnn import make_fnn
from repro_torch.models.lstm_lm import make_lstm_lm

__all__ = ["make_fnn", "make_lstm_lm", "transformer", "ArchConfig", "MLAConfig",
           "MoEConfig", "SSMConfig"]
