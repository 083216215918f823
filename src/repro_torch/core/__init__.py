from repro_torch.core.api import get_norm, get_softmax

__all__ = ["get_norm", "get_softmax"]
