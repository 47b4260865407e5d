"""The paper's core: confidence scores, the LtC loss and its baselines,
cascade evaluation, δ selection, calibration, and gate bookkeeping."""
from repro_torch.core import confidence, server  # noqa: F401
