"""Step builders of the port of ``repro.dist``: the training step, the serve
engine's decode step and its chunked prefill step (one device), and the
DFedRW pod deployment: gossip over the pods (``dist.gossip``), the gossip
step and the federated train step. Sharding a model over devices is
ROADMAP.md queue A, item 11b."""
from repro_torch.dist.gossip import (
    GossipConfig, gossip_mix, make_expander_weights, make_ring_weights, mixing_weights,
    walk_permute_batch,
)
from repro_torch.dist.steps import (
    make_fed_train_step, make_gossip_step, make_prefill_step, make_serve_step,
    make_train_step,
)

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step", "make_gossip_step",
           "make_fed_train_step", "GossipConfig", "gossip_mix", "mixing_weights",
           "make_ring_weights", "make_expander_weights", "walk_permute_batch"]
