"""Host-side data processing: the file readers of SemanticKITTI and
Semantic3D, grid subsampling, class weights and the camera projections of
KITTI frames.

Counterpart of ``open3d_ml_tpu/datasets/utils/dataprocessing.py``
``DataProcessing.grid_subsampling``, whose body is the numpy sort-reduce of
``open3d_ml_tpu/ops/subsample.py`` (the same numpy operations in the same
order give the same bits), ``get_class_weights``, ``load_pc_kitti``,
``load_label_kitti``, ``load_pc_semantic3d``, ``load_label_semantic3d``,
and ``world2cam``, ``cam2img`` and ``remove_outside_points``. The
matrices are [4, 4] in the row-vector convention (points [N, 4] @
matrix).
"""

import numpy as np


class DataProcessing:

    @staticmethod
    def grid_subsampling(points, features=None, labels=None, grid_size=0.1):
        """Barycenter grid subsampling: the points of one voxel of edge
        ``grid_size`` become their barycenter, their features the mean and
        their labels the majority vote (ties to the larger label id).

        points [N, 3] float32, features [N, D] or None, labels [N] or None.
        Returns sub_points, then sub_features and sub_labels where given;
        a single array when neither is.
        """
        points = np.asarray(points, np.float32)
        coords = np.floor((points - points.min(axis=0)) / grid_size)
        coords = coords.astype(np.int64)
        dims = coords.max(axis=0) + 1
        key = (coords[:, 2] * dims[1] + coords[:, 1]) * dims[0] + coords[:, 0]

        uniq, inv, counts = np.unique(key, return_inverse=True,
                                      return_counts=True)
        nv = uniq.shape[0]
        denom = counts[:, None].astype(np.float32)

        sub_points = np.zeros((nv, 3), np.float64)
        np.add.at(sub_points, inv, points.astype(np.float64))
        sub_points = (sub_points / denom).astype(np.float32)

        out = [sub_points]
        if features is not None:
            features = np.asarray(features)
            sub_feat = np.zeros((nv, features.shape[1]), np.float64)
            np.add.at(sub_feat, inv, features.astype(np.float64))
            out.append((sub_feat / denom).astype(np.float32))
        if labels is not None:
            labels = np.asarray(labels).reshape(-1).astype(np.int64)
            # majority vote per voxel: count (voxel, label) pairs
            nl = int(labels.max()) + 1 if labels.size else 1
            pair = inv.astype(np.int64) * nl + labels
            pair_uniq, pair_counts = np.unique(pair, return_counts=True)
            vox = pair_uniq // nl
            lab = pair_uniq % nl
            # sorted by (voxel, count, label), the last entry per voxel wins
            order = np.lexsort((lab, pair_counts, vox))
            vox_o, lab_o = vox[order], lab[order]
            last = np.concatenate([vox_o[1:] != vox_o[:-1], [True]])
            sub_labels = np.zeros((nv,), np.int32)
            sub_labels[vox_o[last]] = lab_o[last].astype(np.int32)
            out.append(sub_labels)
        if len(out) == 1:
            return out[0]
        return tuple(out)

    @staticmethod
    def load_pc_kitti(pc_path):
        """A velodyne ``.bin`` scan: [N, 4] float32 (x, y, z, remission)."""
        scan = np.fromfile(pc_path, dtype=np.float32)
        return scan.reshape((-1, 4))

    @staticmethod
    def load_label_kitti(label_path, remap_lut):
        """A ``.label`` file's training classes [N] int32: the lower 16
        bits of each uint32 (the upper 16 hold the instance) through
        ``remap_lut``."""
        label = np.fromfile(label_path, dtype=np.uint32).reshape(-1)
        sem_label = label & 0xFFFF
        return remap_lut[sem_label].astype(np.int32)

    @staticmethod
    def load_pc_semantic3d(filename):
        """A Semantic3D ``.txt`` cloud: [N, 7] float32 rows (x, y, z,
        intensity, r, g, b)."""
        return np.loadtxt(filename, dtype=np.float32)

    @staticmethod
    def load_label_semantic3d(filename):
        """A Semantic3D ``.labels`` file: [N] int32."""
        return np.loadtxt(filename, dtype=np.int32).reshape(-1)

    @staticmethod
    def get_class_weights(num_per_class):
        """Inverse-frequency class weights 1 / (freq + 0.02), float32, of
        per-class point counts."""
        num_per_class = np.array(num_per_class, dtype=np.float32)
        weight = num_per_class / float(np.sum(num_per_class))
        return 1.0 / (weight + 0.02)

    @staticmethod
    def invT(T):
        """The inverse of a [4, 4] rigid or affine transform in the
        row-vector convention (points [N, 4] @ T)."""
        R = T[:3, :3]
        t = T[3:, :3]
        Rinv = np.linalg.inv(R)
        tinv = t @ -Rinv
        M = np.concatenate([Rinv, tinv], axis=0)
        return np.concatenate([M, [[0], [0], [0], [1]]], axis=1)

    @staticmethod
    def world2cam(points, world_cam):
        """Lidar (world) -> camera coordinates [N, 3]."""
        pts = np.hstack(
            (points[:, :3], np.ones((points.shape[0], 1), np.float32)))
        return (pts @ world_cam)[..., :3]

    @staticmethod
    def cam2world(points, world_cam):
        """Camera -> lidar (world) coordinates [N, 3]: ``world2cam``'s
        inverse, through ``invT``."""
        cam_world = DataProcessing.invT(world_cam)
        pts = np.hstack(
            (points[:, :3], np.ones((points.shape[0], 1), np.float32)))
        return (pts @ cam_world)[..., :3]

    @staticmethod
    def cam2img(points, cam_img):
        """Camera -> image plane: ([N, 2] pixels, [N] rectified depth)."""
        pts = np.hstack(
            (points[:, :3], np.ones((points.shape[0], 1), np.float32)))
        proj = pts @ cam_img
        pts_img = proj[:, :2] / proj[:, 3:4]
        depth = proj[:, 2] - cam_img[3, 2]
        return pts_img, depth

    @staticmethod
    def remove_outside_points(points, world_cam, cam_img, image_shape):
        """The points that project inside the image, at depth >= 0."""
        pts_cam = DataProcessing.world2cam(points[:, :3], world_cam)
        pts_img, depth = DataProcessing.cam2img(pts_cam, cam_img)
        ok_x = (pts_img[:, 0] >= 0) & (pts_img[:, 0] < image_shape[1])
        ok_y = (pts_img[:, 1] >= 0) & (pts_img[:, 1] < image_shape[0])
        return points[ok_x & ok_y & (depth >= 0)]
