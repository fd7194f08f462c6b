"""Step builders for the pod-scale LM paths (the port of ``repro.dist``):
so far the single-pod training step. Sharding, gossip and the federated,
serve and prefill steps are ROADMAP.md queue A, items 11 and 12."""
from repro_torch.dist.steps import make_train_step

__all__ = ["make_train_step"]
