from repro_torch.data.synthetic import FederatedDataset, synthetic_image_classification

__all__ = ["synthetic_image_classification", "FederatedDataset"]
