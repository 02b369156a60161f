"""Oriented 3D bounding box (numpy).

Counterpart of ``open3d_ml_tpu/vis/boundingbox.py`` ``BoundingBox3D``: the
box's center, axes, size, class and score, its corners, and its line set
as a dict of numpy arrays (``create_lines(..., out_format="dict")``),
which the boxes' TensorBoard summary draws. The open3d ``LineSet`` output
and the image drawing (``project_to_img``, ``plot_rect3d_on_img``) are
not ported.
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

    def corners(self):
        """The 8 box corners [8, 3] (no arrow vertices)."""
        x = 0.5 * self.size[0] * self.left
        y = 0.5 * self.size[1] * self.up
        z = 0.5 * self.size[2] * self.front
        c = self.center
        return np.stack([
            c - x - y - z, c - x - y + z, c - x + y + z, c - x + y - z,
            c + x - y - z, c + x - y + z, c + x + y + z, c + x + y - z
        ])

    @staticmethod
    def create_lines(boxes, lut=None, out_format="dict"):
        """The boxes' line set, 14 vertices and 17 lines a box (its 12
        edges and an arrow out of its front face), as a dict of numpy
        arrays {"vertex_positions", "line_indices", "line_colors",
        "bbox_labels", "bbox_confidences"}. A line's colour is its
        class's in ``lut``, else green for ground truth (confidence -1),
        red for a prediction (confidence in [0, 1]) and grey otherwise.
        Only ``out_format="dict"`` is ported."""
        if out_format != "dict":
            raise ValueError("out_format must be 'dict': the open3d "
                             "LineSet output is not ported")
        nverts = 14
        nlines = 17
        points = np.zeros((nverts * len(boxes), 3), dtype="float32")
        indices = np.zeros((nlines * len(boxes), 2), dtype="int32")
        colors = np.zeros((nlines * len(boxes), 3), dtype="float32")

        for i, box in enumerate(boxes):
            pidx = nverts * i
            x = 0.5 * box.size[0] * box.left
            y = 0.5 * box.size[1] * box.up
            z = 0.5 * box.size[2] * box.front
            arrow_tip = box.center + z + box.arrow_length * box.front
            arrow_mid = box.center + z + 0.6 * box.arrow_length * box.front
            head_length = 0.3 * box.arrow_length
            points[pidx] = box.center + x + y + z
            points[pidx + 1] = box.center - x + y + z
            points[pidx + 2] = box.center - x + y - z
            points[pidx + 3] = box.center + x + y - z
            points[pidx + 4] = box.center + x - y + z
            points[pidx + 5] = box.center - x - y + z
            points[pidx + 6] = box.center - x - y - z
            points[pidx + 7] = box.center + x - y - z
            points[pidx + 8] = box.center + z
            points[pidx + 9] = arrow_tip
            points[pidx + 10] = arrow_mid + head_length * box.up
            points[pidx + 11] = arrow_mid - head_length * box.up
            points[pidx + 12] = arrow_mid + head_length * box.left
            points[pidx + 13] = arrow_mid - head_length * box.left

            i0 = nlines * i
            indices[i0:i0 + nlines] = pidx + np.array(
                [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7),
                 (7, 4), (0, 4), (1, 5), (2, 6), (3, 7), (8, 9), (9, 10),
                 (9, 11), (9, 12), (9, 13)], dtype="int32")
            if lut is not None and box.label_class in lut.labels:
                color = lut.labels[box.label_class].color
                c = (color[0], color[1], color[2])
            elif box.confidence == -1.0:
                c = (0.0, 1.0, 0.0)
            elif 0 <= box.confidence <= 1.0:
                c = (1.0, 0.0, 0.0)
            else:
                c = (0.5, 0.5, 0.5)
            colors[i0:i0 + nlines] = c

        return {
            "vertex_positions": points,
            "line_indices": indices,
            "line_colors": colors,
            "bbox_labels": tuple(b.label_class for b in boxes),
            "bbox_confidences": tuple(b.confidence for b in boxes),
        }
