"""The paper's contribution: the DFedRW / QDFedRW protocol core (flat
engine)."""
from repro_torch.core.graph import Topology, make_topology
from repro_torch.core.walk import StragglerModel, WalkPlan, sample_walks
from repro_torch.core.quantization import QuantConfig, Quantized, dequantize, quantize
from repro_torch.core.flatten import FlatSpec, flatten_tree, make_flat_spec, unflatten_tree
from repro_torch.core.dfedrw import DFedRW, DFedRWConfig, DFedRWState, RoundMetrics
from repro_torch.core.metrics import History, train_loop

__all__ = [
    "Topology", "make_topology",
    "WalkPlan", "sample_walks", "StragglerModel",
    "QuantConfig", "Quantized", "quantize", "dequantize",
    "FlatSpec", "flatten_tree", "make_flat_spec", "unflatten_tree",
    "DFedRW", "DFedRWConfig", "DFedRWState", "RoundMetrics",
    "History", "train_loop",
]
