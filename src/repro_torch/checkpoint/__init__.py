from repro_torch.checkpoint.store import latest_step, load_checkpoint, save_checkpoint

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]
