from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan.ops import ssd_chunked

__all__ = ["ssd_chunked", "ref"]
