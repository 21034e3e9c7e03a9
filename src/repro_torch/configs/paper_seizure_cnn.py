"""The paper's own CNN benchmark (§V): seizure detection with one early
exit after the first conv block (weight=0.01, threshold=0.35 — the paper's
final operating point, 82 % exit rate)."""
from repro_torch.models.cnn import SeizureCNNConfig

CONFIG = SeizureCNNConfig()
