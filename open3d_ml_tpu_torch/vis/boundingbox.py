"""Oriented 3D bounding box (numpy).

Counterpart of ``open3d_ml_tpu/vis/boundingbox.py`` ``BoundingBox3D``, as
far as detection needs it: the box's center, axes, size, class and score.
The line sets and image drawing of the visualizer are not ported.
"""

import numpy as np


class BoundingBox3D:
    """Box defined by its center, orthonormal front/up/left axes and size
    (width, height, depth, edge to edge)."""

    next_id = 1

    def __init__(self, center, front, up, left, size, label_class,
                 confidence, meta=None, show_class=False,
                 show_confidence=False, show_meta=None, identifier=None,
                 arrow_length=1.0):
        assert len(center) == 3 and len(front) == 3
        assert len(up) == 3 and len(left) == 3 and len(size) == 3

        self.center = np.array(center, dtype="float32")
        self.front = np.array(front, dtype="float32")
        self.up = np.array(up, dtype="float32")
        self.left = np.array(left, dtype="float32")
        self.size = size
        self.label_class = label_class
        self.confidence = confidence
        self.meta = meta
        self.show_class = show_class
        self.show_confidence = show_confidence
        self.show_meta = show_meta
        if identifier is not None:
            self.identifier = identifier
        else:
            self.identifier = "box:" + str(BoundingBox3D.next_id)
            BoundingBox3D.next_id += 1
        self.arrow_length = arrow_length

    def __repr__(self):
        s = f"{self.identifier} (class={self.label_class}, " \
            f"conf={self.confidence}"
        if self.meta is not None:
            s += f", meta={self.meta}"
        return s + ")"
