"""The paper's contribution: the DFedRW / QDFedRW protocol core (flat
engine), and the baselines it is compared against."""
from repro_torch.core.graph import Topology, make_topology
from repro_torch.core.walk import StragglerModel, WalkPlan, sample_walks
from repro_torch.core.quantization import QuantConfig, Quantized, dequantize, quantize
from repro_torch.core.flatten import FlatSpec, flatten_tree, make_flat_spec, unflatten_tree
from repro_torch.core.dfedrw import DFedRW, DFedRWConfig, DFedRWState, RoundMetrics
from repro_torch.core.baselines import DSGD, BaselineConfig, DFedAvg, FedAvg
from repro_torch.core.metrics import History, latency_dfedrw, latency_fedavg, train_loop

__all__ = [
    "Topology", "make_topology",
    "WalkPlan", "sample_walks", "StragglerModel",
    "QuantConfig", "Quantized", "quantize", "dequantize",
    "FlatSpec", "flatten_tree", "make_flat_spec", "unflatten_tree",
    "DFedRW", "DFedRWConfig", "DFedRWState", "RoundMetrics",
    "BaselineConfig", "FedAvg", "DFedAvg", "DSGD",
    "History", "train_loop", "latency_fedavg", "latency_dfedrw",
]
