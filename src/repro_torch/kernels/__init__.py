"""Hand-written Hopper kernels for the port's hot spots, each with a plain
PyTorch version in the same package (the CPU path and the card's oracle):

- quantize/: fused stochastic quantize -> dequantize (paper Eq. 12-14), the
             communication hot spot of QDFedRW; CUDA C++ for sm_90a.
- ssd_scan/: the Mamba2 SSD chunked scan of the model zoo's SSM mixer;
             CUDA C++ for sm_90a.
"""
