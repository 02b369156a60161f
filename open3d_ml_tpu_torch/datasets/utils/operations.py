"""Box geometry of the gt-database sampling (host-side numpy).

Counterpart of ``open3d_ml_tpu/datasets/utils/operations.py``, the parts
that ``ObjectSample``, the gt-database writer and PointRCNN's RPN
labels use, the same code: the points inside rotated 3D boxes (points
in the boxes' frame or, given the camera-to-world matrix, in the
camera's), the database draw, the BEV collision test (``ops/iou.py``'s
numpy ``iou_bev``) and the per-class draw. Each random
step draws from the ``rng`` it is given, in the JAX package's order.
"""

import copy

import numpy as np

from ...ops.iou import iou_bev


def corners_3d(dims, origin):
    """Box corners [N, 8, 3] relative to the box's ``origin`` of per-axis
    lengths [N, 3], in KITTI's corner order."""
    dims = np.asarray(dims)
    corners_norm = np.stack(np.unravel_index(np.arange(8), [2] * 3),
                            axis=1).astype(dims.dtype)
    corners_norm = corners_norm[[0, 1, 3, 2, 4, 5, 7, 6]]
    corners_norm = corners_norm - np.array(origin, dtype=dims.dtype)
    return dims.reshape(-1, 1, 3) * corners_norm.reshape(1, 8, 3)


def rotation_z(points, angles):
    """Rotate point sets [N, P, 3] by per-set angles [N] about z."""
    rot_sin = np.sin(angles)
    rot_cos = np.cos(angles)
    ones = np.ones_like(rot_cos)
    zeros = np.zeros_like(rot_cos)
    rot_mat_T = np.stack([[rot_cos, -rot_sin, zeros],
                          [rot_sin, rot_cos, zeros],
                          [zeros, zeros, ones]])
    return np.einsum("aij,jka->aik", points, rot_mat_T)


def center_to_corner_box3d(centers, dims, angles, origin=(0.5, 0.5, 0)):
    """Corners [N, 8, 3] of lidar-frame boxes (center [N, 3], dims
    [N, 3], yaw [N]; ``origin`` the center's place in the box)."""
    corners = rotation_z(corners_3d(dims, origin), angles)
    return corners + np.reshape(centers, (-1, 1, 3))


def corner_to_surfaces_3d(corners):
    """[N, 8, 3] corners -> [N, 6, 4, 3] faces with inward normals."""
    return np.array([
        [corners[:, 0], corners[:, 1], corners[:, 2], corners[:, 3]],
        [corners[:, 7], corners[:, 6], corners[:, 5], corners[:, 4]],
        [corners[:, 0], corners[:, 3], corners[:, 7], corners[:, 4]],
        [corners[:, 1], corners[:, 5], corners[:, 6], corners[:, 2]],
        [corners[:, 0], corners[:, 4], corners[:, 5], corners[:, 1]],
        [corners[:, 3], corners[:, 2], corners[:, 6], corners[:, 7]],
    ]).transpose([2, 0, 1, 3])


def surface_equ_3d(polygon_surfaces):
    """Plane equations (normal, -d) of faces [P, S, >= 3, 3] with inward
    normals."""
    surface_vec = polygon_surfaces[:, :, :2, :] - \
        polygon_surfaces[:, :, 1:3, :]
    normal_vec = np.cross(surface_vec[:, :, 0, :], surface_vec[:, :, 1, :])
    d = np.einsum("aij, aij->ai", normal_vec, polygon_surfaces[:, :, 0, :])
    return normal_vec, -d


def points_in_convex_polygon_3d(points, polygon_surfaces):
    """Membership [num_points, num_polygons] of points in convex
    polyhedra given by their faces."""
    num_polygons, num_surfaces = polygon_surfaces.shape[:2]
    normal_vec, d = surface_equ_3d(polygon_surfaces[:, :, :3, :])
    pts = points.reshape(points.shape[0], 1, 1, 3)
    nv = normal_vec.reshape(1, num_polygons, num_surfaces, 3)
    sign = np.sum(pts * nv, axis=-1) + d
    return np.all(sign < 0, axis=-1)


def points_in_box(points, rbbox, origin=(0.5, 0.5, 0), camera_frame=False,
                  cam_world=None):
    """Membership [N, M] of points [N, >= 3] in rotated 3D boxes [M, 7]
    (x, y, z, w, l, h, yaw; ``origin`` the centre's place in the box, z
    at the bottom by default). With ``camera_frame`` the points are in
    the camera frame and ``cam_world`` (4 x 4, row vectors) takes them
    to the boxes' frame first, as PointRCNN's RPN labels need."""
    if len(rbbox) == 0:
        return np.zeros((0, 7))
    if camera_frame:
        if cam_world is None:
            raise ValueError("camera-frame points need cam_world, the "
                             "camera-to-world matrix")
        points = np.hstack(
            (points, np.ones((points.shape[0], 1), dtype=np.float32)))
        points = np.matmul(points, cam_world)[..., :3]
    rbbox = np.array(rbbox)
    corners = center_to_corner_box3d(rbbox[:, :3], rbbox[:, 3:6],
                                     rbbox[:, 6], origin=origin)
    surfaces = corner_to_surfaces_3d(corners)
    return points_in_convex_polygon_3d(points[:, :3], surfaces)


def random_sample(files, num, rng):
    """``num`` distinct items of ``files`` drawn from ``rng`` (all of them
    when there are no more)."""
    if len(files) <= num:
        return list(files)
    idx = rng.choice(len(files), num, replace=False)
    return [files[i] for i in idx]


def box_collision_test(boxes, qboxes):
    """Whether each box of ``boxes`` overlaps (BEV) each of ``qboxes``:
    a [len(boxes), len(qboxes)] bool matrix."""
    b = np.array([box.to_xyzwhlr() for box in boxes], dtype=np.float32)
    q = np.array([box.to_xyzwhlr() for box in qboxes], dtype=np.float32)
    b = b[:, [0, 1, 3, 4, 6]]
    q = q[:, [0, 1, 3, 4, 6]]
    return iou_bev(b, q) > 1e-8


def sample_class(class_name, num, gt_boxes, db_boxes, rng):
    """Copies of up to ``num`` boxes drawn from ``db_boxes``, each kept only
    where it collides with no gt box and no drawn box kept before it."""
    if num == 0:
        return []
    sampled = copy.deepcopy(random_sample(db_boxes, num, rng=rng))

    num_gt = len(gt_boxes)
    num_sampled = len(sampled)
    boxes = list(gt_boxes) + sampled
    coll_mat = box_collision_test(boxes, boxes)
    diag = np.arange(len(boxes))
    coll_mat[diag, diag] = False

    valid = []
    for i in range(num_gt, num_gt + num_sampled):
        if coll_mat[i].any():
            coll_mat[i] = False
            coll_mat[:, i] = False
        else:
            valid.append(sampled[i - num_gt])
    return valid


def remove_points_in_boxes(points, boxes):
    """The points inside none of the boxes."""
    flat_boxes = [box.to_xyzwhlr() for box in boxes]
    masks = points_in_box(points, flat_boxes)
    return points[np.logical_not(masks.any(-1))]
