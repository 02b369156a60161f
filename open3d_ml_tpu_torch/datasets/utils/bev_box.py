"""BEVBox3D: a 3D box that rotates about z only (numpy).

Counterpart of ``open3d_ml_tpu/datasets/utils/bev_box.py``, the same code.
World frame: z up, x front (yaw pi/2); the box center is its geometric
center, ``to_xyzwhlr``'s (x, y, z) its bottom center. The camera-frame
conversions follow KITTI (y down, the box's y at its bottom face).
"""

import numpy as np

from ...vis.boundingbox import BoundingBox3D

# the KITTI line of a box without a camera matrix fails, in JAX too
NO_CAMERA_FAULT = (
    "ROADMAP.md queue 3, 'The nuScenes, Lyft and Argoverse test splits "
    "cannot save their boxes': their frames carry no camera matrix "
    "(cam_img), so a detected box has no image rectangle, and "
    "save_test_result's KITTI line fails on it "
    "(open3d_ml_tpu/datasets/utils/bev_box.py:44, in JAX too)")


class BEVBox3D(BoundingBox3D):

    def __init__(self, center, size, yaw, label_class, confidence,
                 world_cam=None, cam_img=None, **kwargs):
        """Args:
            center: (x, y, z) geometric center of the box (world frame).
            size: (width, height, depth) edge-to-edge.
            yaw: rotation around z; 0 along -y, increasing toward +x.
            label_class: class name or id.
            confidence: score (-1.0 marks ground truth).
            world_cam: [4,4] world->camera (row-vector convention).
            cam_img: [4,4] camera->image.
        """
        self.yaw = yaw
        self.world_cam = world_cam
        self.cam_img = cam_img

        left = [np.cos(self.yaw), -np.sin(self.yaw), 0]
        front = [np.sin(self.yaw), np.cos(self.yaw), 0]
        up = [0, 0, 1]
        super().__init__(center, front, up, left, size, label_class,
                         confidence, **kwargs)

        self.points_inside_box = np.array([])
        self.level = self.get_difficulty()
        self.dis_to_cam = np.linalg.norm(self.to_camera()[:3])

    def to_kitti_format(self, score=1.0):
        """Serialize to a KITTI label line."""
        box2d = self.to_img()
        if box2d is None:
            raise TypeError(f"no image rectangle: {NO_CAMERA_FAULT}")
        box2d[2:] += box2d[:2]  # (cx,cy,w,h) -> (x1,y1,x2,y2)
        truncation = -1
        occlusion = -1
        box = self.to_camera()
        center = box[:3]
        size = box[3:6]
        ry = box[6]
        x, z = center[0], center[2]
        beta = np.arctan2(z, x)
        alpha = -np.sign(beta) * np.pi / 2 + beta + ry
        return ("%s %.2f %d %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f %.2f "
                "%.2f %.2f %.2f %.2f") % (
                    self.label_class, truncation, occlusion, alpha, box2d[0],
                    box2d[1], box2d[2], box2d[3], size[0], size[1], size[2],
                    center[0], center[1], center[2], ry, score)

    def generate_corners3d(self):
        """[8,3] corners of this box in camera coordinates."""
        w, h, l = self.size
        x_corners = [l / 2, l / 2, -l / 2, -l / 2,
                     l / 2, l / 2, -l / 2, -l / 2]
        y_corners = [0, 0, 0, 0, -h, -h, -h, -h]
        z_corners = [w / 2, -w / 2, -w / 2, w / 2,
                     w / 2, -w / 2, -w / 2, w / 2]
        R = np.array([[np.cos(self.yaw), 0, np.sin(self.yaw)],
                      [0, 1, 0],
                      [-np.sin(self.yaw), 0, np.cos(self.yaw)]])
        corners3d = np.dot(R, np.vstack([x_corners, y_corners, z_corners])).T
        return corners3d + self.to_camera()[:3]

    def to_xyzwhlr(self):
        """7-vector (x, y, z, w, l, h, yaw) with (x,y,z) the bottom center."""
        bbox = np.zeros((7,))
        bbox[0:3] = self.center - [0, 0, self.size[1] / 2]
        bbox[3:6] = np.array(self.size)[[0, 2, 1]]
        bbox[6] = self.yaw
        return bbox

    def to_camera(self):
        """7-vector (x, y, z, l, h, w, yaw) in camera frame (bottom center).

        Without a world_cam matrix, axes are permuted only.
        """
        if self.world_cam is None:
            return self.to_xyzwhlr()[[1, 2, 0, 4, 5, 3, 6]]
        bbox = np.zeros((7,))
        bbox[0:3] = self.center - [0, 0, self.size[1] / 2]
        bbox[0:3] = (np.array([*bbox[0:3], 1.0]) @ self.world_cam)[:3]
        bbox[3:6] = [self.size[1], self.size[0], self.size[2]]  # h, w, l
        bbox[6] = self.yaw
        return bbox

    def to_img(self):
        """Project to a 2D image box (cx, cy, w, h)."""
        if self.cam_img is None:
            return None
        corners = self.generate_corners3d()
        corners = np.concatenate(
            [corners, np.ones((corners.shape[0], 1))], axis=-1)
        bbox_img = np.matmul(corners, self.cam_img)
        bbox_img = bbox_img[:, :2] / bbox_img[:, 3:]
        minxy = np.min(bbox_img, axis=0)
        maxxy = np.max(bbox_img, axis=0)
        size = maxxy - minxy
        return np.concatenate([minxy + size / 2, size])

    def get_difficulty(self):
        """KITTI-style difficulty by projected box height (0 easiest)."""
        if self.cam_img is None:
            return 0
        heights = [40, 25]
        height = self.to_img()[3] + 1
        diff = -1
        for j in range(len(heights)):
            if height >= heights[j]:
                diff = j
                break
        return diff

    def to_dict(self):
        return {
            "bbox": self.to_camera(),
            "label": self.label_class,
            "score": self.confidence,
            "difficulty": self.level,
        }

    @staticmethod
    def to_dicts(bboxes):
        """Batch export for the mAP metric (arrays keyed like to_dict)."""
        box_dicts = {
            "bbox": np.empty((len(bboxes), 7)),
            "label": np.empty((len(bboxes),), dtype="<U20"),
            "score": np.empty((len(bboxes),)),
            "difficulty": np.empty((len(bboxes),)),
        }
        for i, box in enumerate(bboxes):
            d = box.to_dict()
            for k in d:
                box_dicts[k][i] = d[k]
        return box_dicts
