"""The paper's own transformer benchmark (§V): seizure detection with one
early exit after the first encoder layer (weight=0.1, threshold=0.45 —
the paper's final operating point, 73 % exit rate)."""
from repro_torch.models.cnn import SeizureTransformerConfig

CONFIG = SeizureTransformerConfig()
