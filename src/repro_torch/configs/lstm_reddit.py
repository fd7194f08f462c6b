"""The paper's language model (DFedRW §VI-F): 50K-vocab 128-d embedding,
2-layer 256-d LSTM. The synthetic stand-in uses a reduced vocab by default;
``LSTM(vocab=50_000)`` is the published width."""
from repro_torch.models.lstm_lm import make_lstm_lm

LSTM = lambda vocab=1000: make_lstm_lm(vocab=vocab, embed=128, hidden=256, layers=2)
