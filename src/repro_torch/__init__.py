"""DFedRW: Decentralized Federated Averaging via Random Walk — the PyTorch
port for one NVIDIA H100, beside the JAX package ``repro`` (its reference).

Subpackages mirror ``repro``'s layout: core (the paper's protocol), data,
kernels (hand-written CUDA C++ for sm_90a, each with a plain PyTorch
version), models, optim, launch. Nothing here imports ``jax`` or ``repro``.
Entry points run on the card (``device="cuda"``) unless given
``device="cpu"``.
"""
__version__ = "0.1.0"
