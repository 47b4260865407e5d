"""Confidence scores and gate bookkeeping for the serving path."""
from repro_torch.core import confidence, server  # noqa: F401
