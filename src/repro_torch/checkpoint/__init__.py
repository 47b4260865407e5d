from repro_torch.checkpoint.checkpoint import load, save

__all__ = ["load", "save"]
