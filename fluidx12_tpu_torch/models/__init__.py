"""The library API: the full smoke pipeline as one model object."""

from fluidx12_tpu_torch.models.smoke import SmokeModel

__all__ = ["SmokeModel"]
