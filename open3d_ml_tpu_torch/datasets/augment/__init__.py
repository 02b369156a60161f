"""Host-side augmentations."""

from .augmentation import SemsegAugmentation

__all__ = ["SemsegAugmentation"]
