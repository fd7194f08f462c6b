"""The paper's own image-classification models (DFedRW §VI-A):
2FNN (784-100-10) and 3FNN (784-200-200-10)."""
from repro_torch.models.fnn import make_fnn

FNN2 = lambda: make_fnn((100,))
FNN3 = lambda: make_fnn((200, 200))
