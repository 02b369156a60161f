"""Detection metrics of the port."""

from .mAP import mAP

__all__ = ["mAP"]
