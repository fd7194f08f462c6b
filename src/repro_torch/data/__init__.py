from repro_torch.data.synthetic import (
    FederatedDataset,
    synthetic_image_classification,
    synthetic_token_stream,
)

__all__ = ["synthetic_image_classification", "synthetic_token_stream", "FederatedDataset"]
