"""Step builders of the port of ``repro.dist``: the training step, the serve
engine's decode step and its chunked prefill step (on one device, or
tensor-parallel on a mesh's model axis), the DFedRW pod deployment (gossip
over the pods, ``dist.gossip``; the gossip step and the federated train
step), the sharding rules (``dist.sharding``) and the mesh axes that
carry them out (``dist.parallel``): the model axis (tensor-parallel
serving and training, its collectives differentiable) and the data axis
(data-parallel training, and the serve engine's slots split over its
ranks; each pod's data-parallel step on a pod mesh with a data axis)."""
from repro_torch.dist.gossip import (
    GossipConfig, gossip_mix, make_expander_weights, make_ring_weights, mixing_weights,
    walk_permute_batch,
)
from repro_torch.dist.parallel import MeshAxis
from repro_torch.dist.sharding import (
    MeshShape, batch_specs, cache_specs, gather_tree, model_specs, opt_specs, param_specs,
    serve_arg_specs, shard_tree, slot_rows, spec_for_leaf,
)
from repro_torch.dist.steps import (
    make_fed_train_step, make_gossip_step, make_prefill_step, make_serve_step,
    make_train_step,
)

__all__ = ["make_train_step", "make_serve_step", "make_prefill_step", "make_gossip_step",
           "make_fed_train_step", "GossipConfig", "gossip_mix", "mixing_weights",
           "make_ring_weights", "make_expander_weights", "walk_permute_batch", "MeshAxis",
           "MeshShape", "spec_for_leaf", "param_specs", "opt_specs", "batch_specs",
           "cache_specs", "serve_arg_specs", "slot_rows", "model_specs", "shard_tree",
           "gather_tree"]
