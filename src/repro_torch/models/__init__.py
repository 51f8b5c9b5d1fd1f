"""Model definitions; `build_model(cfg)` builds an arch of `configs`."""
from repro_torch.models.model_zoo import build_model  # noqa: F401
