"""Host-side augmentations."""

from .augmentation import Augmentation, ObjdetAugmentation, SemsegAugmentation

__all__ = ["Augmentation", "ObjdetAugmentation", "SemsegAugmentation"]
