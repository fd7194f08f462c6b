"""Step builders for the LM paths of one device (the port of ``repro.dist``):
the training step, the serve engine's decode step and its chunked prefill
step. Sharding, gossip and the federated step are ROADMAP.md queue A,
item 11."""
from repro_torch.dist.steps import make_prefill_step, make_serve_step, make_train_step

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step"]
