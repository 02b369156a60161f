"""PointRCNN training in the port (``open3d_ml_tpu_torch``) against the JAX
package, on the CPU: the camera-frame ``points_in_box`` and the RPN's
per-point labels, ``iou_3d_elementwise``, the bin loss, both stages'
losses, the roi sampling, the jitter and the RCNN targets on the JAX
functions' own draws, one float32 training step of each mode, the
frozen-RPN AdamW, the stage-1 -> stage-2 hand-off, the dropout
generators, ``run_train`` in both modes and the command line.

Inputs are made with numpy from a seed and go through both packages; the
nets run on JAX variables drawn with numpy (``draw_variables``, shapes
from ``jax.eval_shape``, so no JAX init compiles), carried into the port
by ``utils/convert_jax.py``. The steps run at the small config of
``tests/test_pointrcnn.py``'s RCNN-mode test (``STEP``: 512 points,
narrow SA widths, 16 rois an image). Their dropout is one keep mask in
both packages, drawn with numpy: flax's ``nn.vmap`` lifts no
``intermediates`` collection, so the JAX net's own masks cannot be read
out; the JAX ``_ConvHead`` is given a Dropout with that mask
(``_jax_fixed_dropout``), the port's heads ``chip_smoke._FixedDropout``.
The roi sampling's draws are the JAX key's, split as the JAX functions
split it (``jax_draws``; in the step, read out of the JAX net by a
wrapper of ``rcnn_targets`` that returns them beside its targets), and
passed to the port's functions, which take their draws as tensors.

Tolerances, each with its reason:

* labels, ``points_in_box``, the transform: bit-equal (the same numpy
  code);
* ``iou_3d_elementwise`` numpy: bit-equal to the JAX numpy path; torch
  vs XLA 1e-5 absolute but on coincident boxes (ROADMAP queue 3: their
  IoU is decided by rounding);
* the losses: 1e-5 relative (XLA fuses the sums);
* roi sampling, jitter and targets: the same slots, ok flags and labels,
  boxes within 1e-5; the IoUs XLA and torch compute may round apart, so
  a sample holding an IoU within ``NEAR_IOU`` of a threshold is counted
  and left out, and the count asserted small (0 at these seeds);
* a step: against the JAX step run in float64 (``_check_step``), whose
  own float32 train-mode forward lies 1.5e-4 relative L2 from float64
  (its batch statistics' sums), the port's 9e-6 (measured on the RPN
  step's scene). The port's float64 step: loss 1e-6, each gradient 1e-5
  and each BatchNorm statistic 1e-6 (both packages compute the losses
  and the 3-NN weights in float32). Its float32 step: loss 1e-5
  relative, the gradients together and each BatchNorm statistic 1e-4
  relative L2. AdamW on the same gradients 1e-6 (as
  ``test_torch_pp_train.py::test_adamw_equals_optax``).
"""

import shutil
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from open3d_ml_tpu.datasets import KITTI as JaxKITTI
from open3d_ml_tpu.datasets.utils import DataProcessing as JaxDP
from open3d_ml_tpu.datasets.utils import operations as jops
from open3d_ml_tpu.models import PointRCNN as JaxPointRCNN
from open3d_ml_tpu.models import point_rcnn as jpr
from open3d_ml_tpu.ops import iou as jiou
from open3d_ml_tpu.utils import Config as JaxConfig
from open3d_ml_tpu_torch import run_pipeline
from open3d_ml_tpu_torch.datasets import KITTI
from open3d_ml_tpu_torch.datasets.utils import DataProcessing
from open3d_ml_tpu_torch.datasets.utils import operations as tops
from open3d_ml_tpu_torch.models import PointRCNN
from open3d_ml_tpu_torch.models import point_rcnn as tpr
from open3d_ml_tpu_torch.models.common import Dropout
from open3d_ml_tpu_torch.ops import iou as tiou
from open3d_ml_tpu_torch.pipelines import ObjectDetection
from open3d_ml_tpu_torch.utils import collect_bboxes, load_jax_variables
from open3d_ml_tpu_torch.utils.convert_jax import (jax_to_state_dict,
                                                   net_layout,
                                                   state_dict_to_jax)

from test_torch_pointrcnn import _np, _rel, dense_scene, draw_variables
from test_torch_pointrcnn_pipeline import PRCNN_YML, kitti_root  # noqa: F401

MEAN_SIZE = [1.52, 1.63, 3.88]
# tests/test_pointrcnn.py's RCNN-mode config (its ``test_rcnn_mode_train_
# and_loss``)
STEP = dict(
    npoints=512, seed=0,
    rpn={"backbone": {"npoints": [128, 32, 8, 2]},
         "head": {"nms_pre": 256, "nms_post": 32, "mean_size": MEAN_SIZE}},
    rcnn={"SA_config": {"npoints": [32, 8, -1], "radius": [0.2, 0.4, 100],
                        "nsample": [16, 16, 16],
                        "mlps": [[64, 64], [64, 128], [128, 256]]},
          "xyz_up_layer": [64, 64], "cls_out_ch": [128], "reg_out_ch": [128],
          "head": {"nms_pre": 32, "nms_post": 32, "get_ry_fine": True,
                   "loc_scope": 1.5, "num_head_bin": 9,
                   "mean_size": MEAN_SIZE, "nms_thres": 0.1},
          "target_head": {"num_points": 64, "roi_per_image": 16}})
B, N = 2, 512
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
# the float64 step: both packages compute the losses, and the RPN's 3-NN
# weights, in float32, which bounds the loss, the gradients flowing back
# from it and the statistics after the feature propagation
F64_LOSS_TOL = 1e-6
F64_GRAD_TOL = 1e-5
F64_STAT_TOL = 1e-6
NEAR_IOU = 1e-5  # an IoU this near a threshold may fall either side
THRESHOLDS = ("reg_fg_thresh", "cls_fg_thresh", "cls_bg_thresh",
              "cls_bg_thresh_lo")
OPTIMIZER = {"optimizer": {"lr": 0.002, "betas": [0.9, 0.99],
                           "weight_decay": 0.001}, "grad_clip_norm": 2}


@pytest.fixture(autouse=True)
def torch_threads(request):
    """One torch thread a test, but for the command line's (the shipped
    widths): at these sizes torch's thread pool waits far longer than it
    computes once the other test processes hold the cores."""
    threads = torch.get_num_threads()
    if "cli" not in request.node.name:
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def shape_variables(module, *args, seed=0, **kwargs):
    """Flax variables of ``module`` drawn with numpy (``draw_variables``)
    on the shapes ``jax.eval_shape`` gives its init: nothing compiles."""
    key = jax.random.PRNGKey(seed)
    shapes = jax.eval_shape(lambda *a: module.init(
        {"params": key, "dropout": key}, *a, **kwargs), *args)
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    return {c: draw_variables(tree[c], rng) for c in ("params", "batch_stats")
            if c in tree}


def target_cfg(model):
    return model.get_net().target_cfg


def jax_draws(key, m, cfg):
    """``rcnn_targets``' draws from its key, split as the JAX function
    splits it (``sample_rois_for_rcnn``'s three priorities, then each
    jitter's level, moves and keep draws), as the port's draw dict."""
    key, key_fg, key_bg = jax.random.split(key, 3)
    out = {"priority": jnp.stack([jax.random.uniform(k, (m,)) for k in
                                  jax.random.split(key, 3)])}
    fg = tpr.quotas(cfg)[0]
    times = cfg["roi_fg_aug_times"]
    for name, k, slots, a in (("fg", key_fg, fg, times),
                              ("bg", key_bg, cfg["roi_per_image"] - fg, 1)):
        k1, k2, k3 = jax.random.split(k, 3)
        out[f"{name}_level"] = jax.random.randint(
            k1, (slots, a), 0, len(jpr._AUG_RANGE_CONFIG))
        out[f"{name}_jitter"] = jax.random.uniform(k2, (slots, a, 7),
                                                   minval=-1.0, maxval=1.0)
        out[f"{name}_keep"] = jax.random.uniform(k3, (slots, a))
    return out


def _cam_boxes(rng, n, spread=20.0):
    """Camera-frame boxes [n, 7] (x, y, z, h, w, l, ry) of car sizes."""
    b = np.zeros((n, 7), np.float32)
    b[:, 0] = rng.uniform(-spread, spread, n)
    b[:, 1] = rng.uniform(1, 2, n)
    b[:, 2] = rng.uniform(5, 5 + 2 * spread, n)
    b[:, 3:6] = rng.uniform([1.3, 1.4, 3.2], [1.8, 1.9, 4.6], (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _near_rois(rng, gt, n, scale):
    """n rois around the gt boxes [G, 7]: each a gt box moved by up to
    ``scale`` (metres, its size by a share, its heading by radians)."""
    pick = gt[rng.integers(0, len(gt), n)]
    move = rng.uniform(-1, 1, (n, 7)) * scale
    move[:, 3:6] = pick[:, 3:6] * rng.uniform(-0.2, 0.2, (n, 3)) * scale
    return (pick + move).astype(np.float32)


def _iou_near(iou, cfg):
    """Whether any value of ``iou`` lies within ``NEAR_IOU`` of one of the
    sampling's thresholds (and the jitter's)."""
    iou = np.asarray(iou, np.float64)
    return any((np.abs(iou - cfg[t]) <= NEAR_IOU).any() for t in THRESHOLDS)


# ------------------------------------------------------- host-side labels

def test_points_in_box_camera_frame_equals_jax(kitti_root):
    """``points_in_box`` with ``camera_frame`` and ``cam_world`` (camera-
    frame points taken to the lidar frame, boxes in it) and with the
    default origin as ObjectSample calls it: bit-equal to JAX's on the
    KITTI frames; some points inside."""
    split = KITTI(dataset_path=str(kitti_root)).get_split("training")
    inside = 0
    for i in range(len(split)):
        data = split.get_data(i)
        boxes = np.stack([b.to_xyzwhlr() for b in data["bounding_boxes"]])
        world_cam = data["calib"]["world_cam"]
        cam = DataProcessing.world2cam(data["point"][:, :3], world_cam)
        cam_world = DataProcessing.invT(world_cam)
        np.testing.assert_array_equal(cam_world, JaxDP.invT(world_cam))
        got = tops.points_in_box(cam.copy(), boxes, camera_frame=True,
                                 cam_world=cam_world)
        want = jops.points_in_box(cam.copy(), boxes, camera_frame=True,
                                  cam_world=cam_world)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tops.points_in_box(data["point"], boxes),
            jops.points_in_box(data["point"], boxes))
        inside += int(got.sum())
    assert inside > 0
    with pytest.raises(ValueError, match="cam_world"):
        tops.points_in_box(cam, boxes, camera_frame=True)


@pytest.mark.parametrize("split", ["training", "validation"])
def test_rpn_labels_and_transform_equal_jax(split, kitti_root):
    """Mode RPN's transform of the train and validation splits
    (``generate_rpn_training_labels``: fg 1, the ring around a box -1,
    the rest 0, and the box targets of the fg points): bit-equal to
    JAX's from the same seed, points, labels and targets; every label
    present."""
    port = PointRCNN(**dict(STEP, mode="RPN"))
    ref = JaxPointRCNN(**dict(STEP, mode="RPN"))
    p = KITTI(dataset_path=str(kitti_root), val_split=2).get_split(split)
    r = JaxKITTI(dataset_path=str(kitti_root), val_split=2).get_split(split)
    seen = set()
    for i in range(len(p)):
        attr = p.get_attr(i)
        got = port.transform(port.preprocess(p.get_data(i), attr), attr)
        want = ref.transform(ref.preprocess(r.get_data(i), attr), attr)
        for key in ("point", "labels", "bboxes"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["labels"].shape == (N,) and got["bboxes"].shape == (N, 7)
        seen |= set(np.unique(got["labels"]).tolist())
        fg = got["labels"] == 1
        assert (got["bboxes"][~fg] == 0).all()
    assert seen == {-1, 0, 1}


# -------------------------------------------------------------- the IoU

def test_iou_3d_elementwise_equals_jax():
    """One IoU a pair of boxes [2, 300, 7]: the numpy path bit-equal to
    JAX's numpy path; torch within 1e-5 of XLA on every pair but the
    coincident ones (a roi kept as it is by the jitter is one), where
    the fault of queue 3 lets rounding decide; the same values as
    ``iou_3d``'s diagonal."""
    rng = np.random.default_rng(20)
    a = np.stack([_cam_boxes(rng, 300, 3.0) for _ in range(2)])
    b = np.stack([_near_rois(rng, a[i], 300, 0.5) for i in range(2)])
    b[:, :20] = a[:, :20]  # coincident pairs
    def conv(x):
        return np.stack([x[..., 0], x[..., 1] - x[..., 3], x[..., 2],
                         x[..., 4], x[..., 3], x[..., 5], x[..., 6]], -1)

    a, b = conv(a), conv(b)
    np.testing.assert_array_equal(tiou.iou_3d_elementwise(a, b),
                                  jiou.iou_3d_elementwise(a, b, xp=np))
    want = np.asarray(jax.jit(lambda x, y: jiou.iou_3d_elementwise(
        x, y, xp=jnp))(a, b))
    got = _np(tiou.iou_3d_elementwise(torch.from_numpy(a),
                                      torch.from_numpy(b)))
    assert got.shape == (2, 300) and 0 < (got[:, 20:] > 0.5).mean() < 1
    np.testing.assert_allclose(got[:, 20:], want[:, 20:], atol=1e-5)
    diag = np.diagonal(_np(tiou.iou_3d(torch.from_numpy(a[0]),
                                       torch.from_numpy(b[0]))))
    np.testing.assert_array_equal(diag, got[0])


# ------------------------------------------------------------- the losses

@pytest.mark.parametrize("fine", [False, True])
def test_get_reg_loss_equals_jax(fine):
    """The bin loss of 400 rows, a random half selected: the RPN's form
    (12 heading bins over the circle) and the RCNN's (9 bins over the
    quarter about the nearer of a heading and its opposite), x and z
    offsets past the scope (clipped), headings over two turns; each of
    loc, angle and size within ``LOSS_TOL`` of JAX's."""
    rng = np.random.default_rng(21 + fine)
    hc = (PointRCNN(**STEP).rcnn_head_cfg if fine else
          PointRCNN(**STEP).rpn_head_cfg)
    n = 400
    pred = rng.normal(0, 1, (n, hc.reg_channels)).astype(np.float32)
    label = np.concatenate(
        [rng.uniform(-4, 4, (n, 1)), rng.uniform(-1, 1, (n, 1)),
         rng.uniform(-4, 4, (n, 1)), rng.uniform(1, 5, (n, 3)),
         rng.uniform(-2 * np.pi, 2 * np.pi, (n, 1))], 1).astype(np.float32)
    weight = (rng.random(n) < 0.5).astype(np.float32)
    args = (hc.loc_scope, hc.loc_bin_size, hc.num_head_bin, hc.mean_size)
    kw = dict(get_xz_fine=True, get_y_by_bin=hc.get_y_by_bin,
              loc_y_scope=hc.loc_y_scope, loc_y_bin_size=hc.loc_y_bin_size,
              get_ry_fine=fine)
    want = jax.jit(lambda p, l, w: jpr.get_reg_loss(p, l, *args, w, **kw))(
        pred, label, weight)
    got = tpr.get_reg_loss(torch.from_numpy(pred), torch.from_numpy(label),
                           *args, torch.from_numpy(weight), **kw)
    for g, w in zip(got, want):
        assert _rel(_np(g), w) <= LOSS_TOL


def test_stage_losses_equal_jax():
    """``rpn_loss`` (the focal loss with the ring ignored and weights 1 /
    fg points, the bin loss of the fg points, ``loss_weight``) and
    ``rcnn_loss`` (BCE over the labelled rois, the fine-heading bin loss
    of ``reg_valid_mask``'s) on random outputs and labels, each term
    within ``LOSS_TOL`` of JAX's; ``get_loss`` picks by mode."""
    rng = np.random.default_rng(23)
    port = {m: PointRCNN(**dict(STEP, mode=m,
                                rpn=dict(STEP["rpn"], loss_weight=[0.7,
                                                                   1.3])))
            for m in ("RPN", "RCNN")}
    ref = {m: JaxPointRCNN(**dict(STEP, mode=m,
                                  rpn=dict(STEP["rpn"], loss_weight=[0.7,
                                                                     1.3])))
           for m in ("RPN", "RCNN")}
    c_rpn = port["RPN"].rpn_head_cfg.reg_channels
    c_rcnn = port["RCNN"].rcnn_head_cfg.reg_channels
    rpn_out = {"cls": rng.normal(-2, 2, (B, N, 1)),
               "reg": rng.normal(0, 1, (B, N, c_rpn))}
    rpn_in = {"labels": rng.integers(-1, 2, (B, N)).astype(np.int32),
              "bboxes": np.concatenate(
                  [rng.uniform(-3, 3, (B, N, 3)), rng.uniform(1, 4, (B, N, 3)),
                   rng.uniform(-np.pi, np.pi, (B, N, 1))], -1)}
    rcnn_out = {"cls": rng.normal(0, 2, (B, 16, 1)),
                "reg": rng.normal(0, 1, (B, 16, c_rcnn)),
                "cls_label": rng.integers(-1, 2, (B, 16)).astype(np.int32),
                "reg_valid_mask": rng.random((B, 16)) < 0.5,
                "gt_of_rois": np.concatenate(
                    [rng.uniform(-1, 1, (B, 16, 3)),
                     rng.uniform(1, 4, (B, 16, 3)),
                     rng.uniform(-np.pi, np.pi, (B, 16, 1))], -1)}
    cases = (("RPN", rpn_out, rpn_in), ("RCNN", rcnn_out, {}))
    for mode, out, inputs in cases:
        out = {k: np.asarray(v, np.float32) if v.dtype == np.float64 else v
               for k, v in out.items()}
        inputs = {k: np.asarray(v, np.float32) if v.dtype == np.float64
                  else v for k, v in inputs.items()}
        want = jax.jit(ref[mode].get_loss)(out, inputs)
        got = port[mode].get_loss(
            {k: torch.from_numpy(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in inputs.items()})
        assert set(got) == set(want) == {"cls", "reg"}
        for key in got:
            assert _rel(_np(got[key]), want[key]) <= LOSS_TOL, (mode, key)


# ---------------------------------------------------- the RCNN's targets

def _target_inputs(rng, m=64, g=24, counts=(5, 3)):
    """Proposals [B, M, 7] (around the gt boxes at three spreads, and far
    ones; the last 6 invalid), validity, gt boxes [B, G, 7] padded after
    ``counts``, and points [B, N, 3] with features [B, N, 6] near the
    boxes."""
    gt = np.zeros((B, g, 7), np.float32)
    rois, points = [], []
    for i, c in enumerate(counts):
        gt[i, :c] = _cam_boxes(rng, c, 6.0)
        r = np.concatenate([_near_rois(rng, gt[i, :c], 24, 0.15),
                            _near_rois(rng, gt[i, :c], 16, 0.6),
                            _near_rois(rng, gt[i, :c], 12, 1.5),
                            _cam_boxes(rng, m - 52, 6.0)])
        rois.append(r[rng.permutation(m)])
        centre = gt[i, rng.integers(0, c, N), :3] + [0, -0.7, 0]
        points.append(centre + rng.normal(0, 1.2, (N, 3)))
    valid = np.ones((B, m), bool)
    valid[:, -6:] = False
    feats = rng.normal(0, 1, (B, N, 6)).astype(np.float32)
    return (np.stack(rois), valid, gt, np.asarray(counts, np.int32),
            np.stack(points).astype(np.float32), feats)


def test_sample_rois_equals_jax():
    """``sample_rois_for_rcnn`` on the JAX key's priorities: per sample
    the same slots (rois and gt boxes equal), the same ok flags (a quota
    too short fills with the lowest-index rois outside it, not ok), IoUs
    within 1e-5; each quota filled in one sample, and short in the other
    (12 valid proposals), its empty slots not ok."""
    rng = np.random.default_rng(24)
    rois, valid, gt, counts, _, _ = _target_inputs(rng)
    valid[1, 12:] = False  # too few rois for sample 1's quotas
    cfg = target_cfg(PointRCNN(**STEP))
    kw = {k: cfg[k] for k in ("roi_per_image", "fg_ratio", "reg_fg_thresh",
                              "cls_bg_thresh", "cls_bg_thresh_lo",
                              "hard_bg_ratio")}
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    want = jax.tree.map(np.asarray, jax.jit(jax.vmap(
        lambda r, v, g, c, k: jpr.sample_rois_for_rcnn(r, v, g, c, k, **kw)))(
        rois, valid, gt, counts, keys))
    pri = np.stack([np.asarray(jnp.stack([
        jax.random.uniform(k, (rois.shape[1],))
        for k in jax.random.split(key, 3)])) for key in keys])
    got = tpr.sample_rois_for_rcnn(
        torch.from_numpy(rois), torch.from_numpy(valid), torch.from_numpy(gt),
        torch.from_numpy(counts), torch.from_numpy(pri), **kw)
    got = [_np(t) for t in got]
    iou = _np(tpr.roi_gt_iou(torch.from_numpy(rois), torch.from_numpy(gt)))
    near = [_iou_near(iou[i, :, :counts[i]], cfg) for i in range(B)]
    assert sum(near) == 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    np.testing.assert_array_equal(got[3], want[3])
    fg, hard, _ = tpr.quotas(cfg)
    assert got[3][:, :fg].any() and got[3][:, fg:fg + hard].any()
    assert got[3][:, fg + hard:].any() and not got[3].all()


def test_aug_roi_by_noise_equals_jax():
    """The jitter of 32 rois, 10 attempts each, on the JAX key's draws
    (levels, moves, keeps): the same attempt kept (rois within 1e-6),
    the IoU reported within 1e-5 (the pre-jitter IoU where the kept
    attempt is the roi itself); some rois fall back to their last
    attempt, some keep the roi."""
    rng = np.random.default_rng(25)
    gt = _cam_boxes(rng, 32, 6.0)
    rois = np.concatenate([_near_rois(rng, gt[:24], 24, 0.2),
                           _near_rois(rng, gt[24:], 8, 3.0)])
    iou_src = rng.uniform(0, 1, 32).astype(np.float32)
    times, thresh = 10, 0.55
    key = jax.random.PRNGKey(6)
    want = jax.tree.map(np.asarray, jax.jit(lambda r, g, i, k:
                                            jpr.aug_roi_by_noise(
                                                r, g, i, k,
                                                pos_thresh=thresh,
                                                aug_times=times))(
        rois, gt, iou_src, key))
    k1, k2, k3 = jax.random.split(key, 3)
    level = jax.random.randint(k1, (32, times), 0, 5)
    jitter = jax.random.uniform(k2, (32, times, 7), minval=-1.0, maxval=1.0)
    keep = jax.random.uniform(k3, (32, times))
    got = tpr.aug_roi_by_noise(
        *(torch.from_numpy(np.asarray(x))[None] for x in
          (rois, gt, iou_src, level, jitter, keep)), pos_thresh=thresh)
    got_rois, got_iou = _np(got[0][0]), _np(got[1][0])
    np.testing.assert_allclose(got_rois, want[0], atol=1e-6)
    np.testing.assert_allclose(got_iou, want[1], atol=1e-5)
    kept_roi = (got_rois == rois).all(1)
    assert kept_roi.any() and not kept_roi.all()
    assert (got_iou < thresh).any() and (got_iou >= thresh).any()


def test_rcnn_targets_equals_jax():
    """``rcnn_targets`` (sampling, both jitters, ``roipool3d`` and the
    canonical frames, labels) on the JAX key's draws: the same sampled
    rois (within 1e-5), labels and regression masks; pooled inputs and
    canonical gt boxes within 1e-5 of max(1, |value|); every label
    (-1, 0, 1) and both masks present."""
    rng = np.random.default_rng(26)
    rois, valid, gt, counts, xyz, feats = _target_inputs(rng)
    cfg = target_cfg(PointRCNN(**STEP))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    fn = jax.jit(jax.vmap(lambda x, f, r, v, g, c, k: jpr.rcnn_targets(
        x, f, r, v, g, c, k, cfg)))
    want = jax.tree.map(np.asarray, fn(xyz, feats, rois, valid, gt, counts,
                                       keys))
    draws = [jax_draws(k, rois.shape[1], cfg) for k in keys]
    draws = {k: torch.from_numpy(np.stack([np.asarray(d[k]) for d in draws]))
             for k in draws[0]}
    got = tpr.rcnn_targets(*(torch.from_numpy(a) for a in
                             (xyz, feats, rois, valid, gt, counts)),
                           draws, cfg)
    got = {k: _np(v) for k, v in got.items()}
    assert set(got) == set(want)
    iou = _np(tpr.roi_gt_iou(torch.from_numpy(got["roi_boxes3d"]),
                             torch.from_numpy(gt)))
    assert not any(_iou_near(iou[i, :, :counts[i]], cfg) for i in range(B))
    for key in ("cls_label", "reg_valid_mask"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for key in ("roi_boxes3d", "gt_of_rois", "pts_input"):
        g, w = got[key], want[key]
        assert g.shape == w.shape, key
        assert (np.abs(g - w) <= 1e-5 * np.maximum(1, np.abs(w))).all(), key
    assert set(np.unique(got["cls_label"]).tolist()) == {-1, 0, 1}
    assert got["reg_valid_mask"].any() and not got["reg_valid_mask"].all()


# -------------------------------------------------------- training steps

def _jax_fixed_dropout(masks):
    """A flax Dropout for ``jpr``'s heads that applies the keep mask of
    its head (``masks``: {"cls_blocks" / "reg_blocks": [N, C] bool}; one
    mask for every sample of the vmapped batch)."""
    class FixedDropout(fnn.Module):
        rate: float
        deterministic: bool = False

        @fnn.compact
        def __call__(self, x):
            if self.deterministic:
                return x
            head = next(h for h in masks if h in self.scope.path)
            return jnp.where(masks[head], x / (1.0 - self.rate), 0.0)

    class Linen(types.SimpleNamespace):
        def __getattr__(self, name):
            return getattr(fnn, name)

    return Linen(Dropout=FixedDropout)


def _leaves(tree, prefix=()):
    for k, x in tree.items():
        if isinstance(x, dict):
            yield from _leaves(x, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(x)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        if np.asarray(x).dtype == np.float32 else x, tree)


def _jax_step(jmodel, variables, batch):
    """``jax.value_and_grad`` of ``jmodel``'s net in train mode and its
    ``get_loss``, in float64 (``jax.enable_x64``): (loss, losses,
    gradients, updated BatchNorm statistics, outputs), numpy."""
    net = jmodel.get_net()
    with jax.enable_x64(True):
        v, x = _f64(variables), _f64(batch)

        def loss_fn(params):
            out, upd = net.apply(
                {"params": params, "batch_stats": v["batch_stats"]}, x,
                training=True, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(0),
                      "sampling": jax.random.PRNGKey(1)})
            losses = jmodel.get_loss(out, x)
            return sum(losses.values()), (upd["batch_stats"], losses, out)

        (loss, (stats, losses, out)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
        return jax.tree.map(np.asarray, (loss, losses, grads, stats, out))


@pytest.fixture(scope="module")
def step_setup():
    """The dense grid scene (2 x 512 points of the 1/64 grid in a 4 m
    cube) of the RPN step and a scene of clusters off the grid for the
    RCNN step (a roi's rotated grid points would tie its FPS), the
    drawn JAX variables of the mode-RCNN net (the mode-RPN net's are its
    ``rpn`` subtree) and the dropout masks."""
    rng = np.random.default_rng(30)
    dense = dense_scene(np.random.default_rng(5), b=B, n=N, far=0)
    # 8 clusters of 64 points (sigma 0.5 m) out to 60 m: every point has
    # neighbours within the second radius, so the RPN's scores lie apart
    centres = np.stack([rng.uniform(-10, 10, (B, 8)), rng.uniform(0, 2, (B, 8)),
                        rng.uniform(5, 60, (B, 8))], -1)
    clusters = (np.repeat(centres, N // 8, axis=1) +
                rng.normal(0, 0.5, (B, N, 3))).astype(np.float32)
    jnet = JaxPointRCNN(**dict(STEP, mode="RCNN")).get_net()
    v = shape_variables(jnet, {"point": dense}, training=False)
    masks = {h: rng.random((N, 128)) >= 0.5
             for h in ("cls_blocks", "reg_blocks")}
    return {"dense": dense, "clusters": clusters, "v": v, "masks": masks}


def _port_net(mode, v, dtype, masks=None):
    model = PointRCNN(**dict(STEP, mode=mode))
    net = load_jax_variables(model.get_net(), v).to(dtype)
    if masks is not None:
        for head in ("cls_blocks", "reg_blocks"):
            keep = torch.from_numpy(masks[head])[None].expand(B, -1, -1)
            getattr(net.rpn, head).dropout = chip_smoke._FixedDropout(keep)
    return model, net


def _as(x, dtype):
    """A numpy array as a tensor, its floats in ``dtype``."""
    t = torch.from_numpy(np.asarray(x))
    return t.to(dtype) if t.is_floating_point() else t


def _port_step(make, batch, dtype):
    """One step of the port's net from ``make(dtype)`` -> (model, net) in
    train mode on ``batch``, backward included: (model, net, outputs,
    loss, losses)."""
    model, net = make(dtype)
    net.train()
    inputs = {k: _as(a, dtype) for k, a in batch.items()}
    out = net(inputs)
    losses = model.get_loss(out, inputs)
    total = sum(losses.values())
    total.backward()
    return model, net, out, total, losses


def _within(got, want, tol, key):
    """Relative L2 within ``tol``, or within 1e-12 absolute where the
    reference is 0 but for rounding."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.linalg.norm(got - want)
    assert diff <= tol * np.linalg.norm(want) + 1e-12, (key, diff)


def _check_step(steps, ref, prefix):
    """The port's float64 and float32 steps (``_port_step``'s) against the
    JAX float64 step ``ref`` (loss, losses, grads, stats), over the
    parameters and statistics under ``prefix``: float64 loss and each
    term ``F64_LOSS_TOL``, each gradient ``F64_GRAD_TOL``, each statistic
    ``F64_STAT_TOL``; float32 loss and each term ``LOSS_TOL``, the
    gradients together and each statistic ``GRAD_TOL``. (One float32
    gradient alone can be far off in relative terms: a BatchNorm bias
    whose next layer is a train-mode BatchNorm has a gradient of 0 but
    for rounding.) Returns how many gradients and statistics were
    held."""
    loss, losses, grads, stats = ref[:4]
    layout = net_layout(steps[0][1])
    want_g = jax_to_state_dict({"params": grads}, **layout)
    want_s = jax_to_state_dict({"batch_stats": stats}, **layout)
    names = [n for n, _ in steps[0][1].named_parameters()
             if n.startswith(prefix)]
    keys = [k for k in want_s if k.startswith(prefix)]
    for (_, net, _, total, got), (ltol, gtol) in zip(
            steps, ((F64_LOSS_TOL, F64_GRAD_TOL), (LOSS_TOL, None))):
        assert _rel(_np(total), loss) <= ltol
        for key in got:
            assert _rel(_np(got[key]), losses[key]) <= ltol, key
        params = dict(net.named_parameters())
        if gtol is None:  # float32
            _within(np.concatenate([_np(params[n].grad).ravel()
                                    for n in names]),
                    np.concatenate([_np(want_g[n]).ravel() for n in names]),
                    GRAD_TOL, "all gradients")
        else:
            for name in names:
                _within(_np(params[name].grad), _np(want_g[name]), gtol,
                        name)
        state = net.state_dict()
        for key in keys:
            _within(_np(state[key]), _np(want_s[key]),
                    F64_STAT_TOL if gtol else GRAD_TOL, key)
    return len(names), len(keys)


def _adamw_close(model, net, jmodel, params, grads, trainable):
    """One AdamW step of ``get_optimizer`` on the JAX gradients against the
    JAX ``get_optimizer``'s (optax; masked in mode RCNN), both from
    float32 parameters and gradients: every leaf within 1e-6 relative L2,
    the trainable ones moved, the others not. No gradient is clipped,
    though ``OPTIMIZER`` sets ``grad_clip_norm`` 2 and the gradients'
    norm lies far above it: the JAX pipeline never reads it (ROADMAP
    queue 3)."""
    optimizer, scheduler = model.get_optimizer(OPTIMIZER, net)
    assert scheduler is None
    grads = jax.tree.map(lambda g: np.asarray(g, np.float32), grads)
    tx, _ = jmodel.get_optimizer(JaxConfig(OPTIMIZER))
    updates, _ = tx.update(grads, tx.init(params), params)
    want = dict(_leaves(optax.apply_updates(params, updates)))
    torch_grads = jax_to_state_dict({"params": grads}, **net_layout(net))
    for name, p in net.named_parameters():
        p.grad = (torch_grads[name].clone()
                  if name in torch_grads and trainable(name) else None)
    optimizer.step()
    got = state_dict_to_jax(net.state_dict(), **net_layout(net))["params"]
    start = dict(_leaves(params))
    for path, value in _leaves(got):
        assert _rel(value, want[path]) <= 1e-6 or \
            np.array_equal(value, want[path]), path
        moved = np.abs(value - start[path]).max()
        assert (moved > 1e-4) == trainable(".".join(path)), path
        assert np.array_equal(want[path], start[path]) != \
            trainable(".".join(path)), path


def test_train_step_rpn_equals_jax(step_setup, monkeypatch):
    """One step of mode RPN (BatchNorm's batch statistics, both heads'
    dropout on one keep mask) on the grid scene with random labels and
    box targets against ``jax.value_and_grad`` of the JAX net in float64
    (``_check_step``: the port's float64 step to 1e-5 and its float32
    step: loss 1e-5, all gradients 1e-4); then AdamW over the RPN on the JAX
    gradients within 1e-6 of optax's."""
    s = step_setup
    rng = np.random.default_rng(31)
    labels = rng.integers(-1, 2, (B, N)).astype(np.int32)
    regs = np.concatenate([rng.uniform(-3, 3, (B, N, 3)),
                           rng.uniform(1, 4, (B, N, 3)),
                           rng.uniform(-np.pi, np.pi, (B, N, 1))],
                          -1).astype(np.float32)
    batch = {"point": s["dense"], "labels": labels, "bboxes": regs}
    v = {c: {"rpn": s["v"][c]["rpn"]} for c in s["v"]}
    monkeypatch.setattr(jpr, "nn", _jax_fixed_dropout(s["masks"]))
    jmodel = JaxPointRCNN(**dict(STEP, mode="RPN"))
    ref = _jax_step(jmodel, v, batch)

    def make(dtype):
        return _port_net("RPN", v, dtype, s["masks"])

    steps = [_port_step(make, batch, d) for d in (torch.float64,
                                                   torch.float32)]
    model, net = steps[1][:2]
    assert {k for k in net.state_dict()
            if not k.endswith("num_batches_tracked")} == set(
        jax_to_state_dict(v, **net_layout(net)))  # the RPN's only
    assert _check_step(steps, ref, "rpn.") >= (50, 30)
    _adamw_close(model, net, jmodel, v["params"], ref[2],
                 lambda n: n.startswith("rpn"))


def test_train_step_rcnn_equals_jax(step_setup, monkeypatch):
    """One step of mode RCNN on the clustered scene, gt boxes placed on
    the port's proposals, against the JAX net's step in float64 (its RPN
    frozen as in eval; its sampling key's draws read out by a wrapper of
    ``rcnn_targets``, beside the points and per-point features it was
    given): the port's net fed the JAX net's points, features and
    proposals (its own RPN still runs, in eval; the serving tests hold
    the RPN and the proposal layer, and a proposal's order may turn on
    rounding) and those draws. The targets
    and labels equal, boxes and pooled inputs within 1e-5, the loss and
    the RCNN's gradients and BatchNorm statistics as ``_check_step``
    holds them; the RPN's gradients are zero in JAX and absent in the
    port, and its weights and statistics after the step and the AdamW
    update (optax's ``masked`` passes the zero updates through; the
    port's AdamW holds the RCNN only) equal the start in both."""
    s = step_setup
    v = s["v"]
    model, net = _port_net("RCNN", v, torch.float32)
    with torch.no_grad():
        cls, reg, xyz, _ = net.rpn(torch.from_numpy(s["clusters"]))
        rois, _, valid = tpr.proposal_layer(cls[..., 0], reg, xyz,
                                            model.rpn_head_cfg, training=True)
    rng = np.random.default_rng(32)
    gt = np.zeros((B, 24, 7), np.float32)
    counts = np.array([6, 5], np.int32)
    for i in range(B):
        pick = _np(rois[i][valid[i]])[:counts[i]]
        gt[i, :counts[i]] = pick + rng.normal(0, 0.02, pick.shape)
    batch = {"point": s["clusters"], "bboxes": gt, "bbox_count": counts}

    real = jpr.rcnn_targets

    def with_draws(x, f, r, rv, g, gc, key, tcfg):
        out = real(x, f, r, rv, g, gc, key, tcfg)
        out.update({f"draw_{k}": d for k, d in
                    jax_draws(key, r.shape[0], dict(tcfg)).items()})
        out.update(replay_xyz=x, replay_feature=f)
        return out

    monkeypatch.setattr(jpr, "rcnn_targets", with_draws)
    jmodel = JaxPointRCNN(**dict(STEP, mode="RCNN"))
    ref = _jax_step(jmodel, v, batch)
    jout = ref[4]
    before = {}

    def make(dtype):
        model, net = _port_net("RCNN", v, dtype)
        before[dtype] = {k: t.clone() for k, t in net.state_dict().items()
                         if k.startswith("rpn.")}
        real_rpn = net.rpn.forward

        def replay(points):
            cls, reg, _, _ = real_rpn(points)
            return cls, reg, _as(jout["replay_xyz"], dtype), None

        net.rpn.forward = replay
        net.point_features = lambda cls, xyz, feats: _as(
            jout["replay_feature"], dtype)
        net.proposals = lambda cls, reg, xyz: tuple(
            _as(jout[k], dtype) for k in ("rois", "scores", "valid"))
        draws = {k[5:]: _as(x, dtype) for k, x in jout.items()
                 if k.startswith("draw_")}
        net.draw = lambda b, m, device: draws
        net.train()
        assert net.training and not net.rpn.training
        return model, net

    steps = [_port_step(make, batch, d) for d in (torch.float64,
                                                   torch.float32)]
    model, net, out = steps[1][:3]
    cfg = net.target_cfg
    iou = _np(tpr.roi_gt_iou(out["roi_boxes3d"], torch.from_numpy(gt)))
    assert not any(_iou_near(iou[i, :, :counts[i]], cfg) for i in range(B))
    for key in ("cls_label", "reg_valid_mask"):
        np.testing.assert_array_equal(_np(out[key]), jout[key], err_msg=key)
    assert set(np.unique(_np(out["cls_label"])).tolist()) == {-1, 0, 1}
    assert _np(out["reg_valid_mask"]).any()
    for key in ("roi_boxes3d", "gt_of_rois", "pts_input"):
        g, w = _np(out[key]), jout[key]
        assert (np.abs(g - w) <= 1e-5 * np.maximum(1, np.abs(w))).all(), key

    assert _check_step(steps, ref, "rcnn.") >= (20, 10)
    grads, stats = ref[2], ref[3]
    for _, port, *_ in steps:
        assert all(p.grad is None for p in port.rpn.parameters())
    assert all((g == 0).all() for _, g in _leaves(grads["rpn"]))
    start = dict(_leaves(v["batch_stats"]["rpn"]))
    for path, value in _leaves(stats["rpn"]):
        np.testing.assert_array_equal(value, start[path])
    mask = model.freeze_rpn_mask(net)
    assert not any(mask[n] for n in mask if n.startswith("rpn."))
    assert all(mask[n] for n in mask if n.startswith("rcnn."))
    _adamw_close(model, net, jmodel, v["params"], grads,
                 lambda n: n.startswith("rcnn"))
    for key, value in before[torch.float32].items():
        assert torch.equal(net.state_dict()[key], value), key


# ------------------------------------------------------------- hand-off

def test_stage_handoff_fault_in_both_packages(kitti_root, tmp_path):
    """Stage 1 -> stage 2, as each package runs it: the JAX variables of
    mode RPN hold no rcnn subtree, and the mode-RCNN net applied to them
    raises flax's ScopeCollectionNotFound (the JAX pipeline's first
    stage-2 step does, on a stage-1 checkpoint); the port's mode-RPN
    state_dict holds the RPN only, a mode-RCNN net's strict
    ``load_state_dict`` of it raises ``HANDOFF_FAULT`` (ROADMAP queue
    3), as does ``run_train`` of mode RCNN given the stage-1 checkpoint;
    ``strict=False`` carries the RPN's weights over."""
    pts = dense_scene(np.random.default_rng(33), b=1, n=N, far=128)
    jrpn = JaxPointRCNN(**dict(STEP, mode="RPN")).get_net()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda p: jrpn.init(
        {"params": key, "dropout": key}, {"point": p}, training=False), pts)
    assert set(shapes["params"]) == {"rpn"}
    jrcnn = JaxPointRCNN(**dict(STEP, mode="RCNN")).get_net()
    with pytest.raises(Exception, match="collection is empty|rcnn") as err:
        jax.eval_shape(lambda v, p: jrcnn.apply(v, {"point": p},
                                                training=False),
                       dict(shapes), pts)
    assert type(err.value).__name__ == "ScopeCollectionNotFound"

    pipe = dict(batch_size=1, val_batch_size=1, num_workers=0, max_epoch=0,
                overlaps=[0.1], difficulties=[0])
    ds = KITTI(dataset_path=str(kitti_root), val_split=2)
    stage1 = ObjectDetection(PointRCNN(**dict(STEP, mode="RPN")), dataset=ds,
                             device="cpu", main_log_dir=str(tmp_path / "1"),
                             **pipe)
    state = stage1.net.state_dict()
    assert state and all(k.startswith("rpn.") for k in state)
    path = stage1.save_ckpt(0)
    model = PointRCNN(**dict(STEP, mode="RCNN", ckpt_path=str(path)))
    stage2 = ObjectDetection(model, dataset=ds, device="cpu",
                             main_log_dir=str(tmp_path / "2"), **pipe)
    with pytest.raises(KeyError, match="queue 3"):
        stage2.net.load_state_dict(state)
    with pytest.raises(KeyError, match="queue 3"):
        stage2.run_train()
    stage2.net.load_state_dict(state, strict=False)
    for k, t in state.items():
        assert torch.equal(stage2.net.state_dict()[k], t)


# ------------------------------------------------------- dropout streams

def test_dropout_generators_seeded_and_global_untouched():
    """The RPN heads' dropout draws from the net's own generators: two
    nets seeded alike drop the same elements, the two heads and two seeds
    differ, torch's global generator is not drawn from; in eval the
    heads are the identity, so serving outputs do not depend on the
    seeds."""
    x = torch.randn(2, 300, 128)

    def heads(seed):
        net = PointRCNN(**STEP).get_net()  # its Linears draw globally
        net.manual_seed(seed)
        out = (net.rpn.cls_blocks.dropout, net.rpn.reg_blocks.dropout)
        assert all(isinstance(d, Dropout) for d in out)
        return out

    nets = [heads(3), heads(3), heads(4)]
    state = torch.get_rng_state()
    a, b, c = ([d.train()(x) != 0 for d in h] for h in nets)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], c[0])
    assert 0.4 < a[0].float().mean() < 0.6
    assert all(torch.equal(d.eval()(x), x) for d in nets[0])
    assert torch.equal(torch.get_rng_state(), state)


def test_pipeline_seeds_the_nets_generators(kitti_root, tmp_path):
    """The pipeline seeds the net's dropout and sampling generators from
    its ``seed``: two pipelines of one seed draw the same roi sampling,
    another seed differs; the draws take nothing from the global
    generator."""
    ds = KITTI(dataset_path=str(kitti_root), val_split=2)

    nets = [ObjectDetection(PointRCNN(**dict(STEP, mode="RCNN")),
                            dataset=ds, device="cpu", seed=seed,
                            main_log_dir=str(tmp_path)).net
            for seed in (1, 1, 2)]
    state = torch.get_rng_state()
    a, b, c = (net.draw(1, 32, torch.device("cpu")) for net in nets)
    assert set(a) == {"priority", "fg_level", "fg_jitter", "fg_keep",
                      "bg_level", "bg_jitter", "bg_keep"}
    assert a["fg_jitter"].shape == (1, 8, 10, 7)
    assert a["bg_level"].shape == (1, 8, 1)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["priority"], c["priority"])
    assert torch.equal(torch.get_rng_state(), state)


# ----------------------------------------------------- pipeline and CLI

PIPE = dict(batch_size=2, val_batch_size=1, num_workers=0, max_epoch=1,
            save_ckpt_freq=1, overlaps=[0.1], difficulties=[0, 1, 2],
            similar_classes={"Van": "Car"})


def test_run_train_both_stages(kitti_root, tmp_path):
    """``run_train`` of mode RPN (2 epochs of one step, validation, two
    checkpoints) and then of mode RCNN in a log directory of its own with
    the RPN's weights (``strict=False``): finite losses, checkpoints,
    validation mAP finite; stage 2 leaves the RPN as it got it."""
    ds = KITTI(dataset_path=str(kitti_root), val_split=2)
    rpn = ObjectDetection(PointRCNN(**dict(STEP, mode="RPN")), dataset=ds,
                          device="cpu", main_log_dir=str(tmp_path / "rpn"),
                          **PIPE)
    start = {k: t.clone() for k, t in rpn.net.state_dict().items()}
    rpn.run_train()
    assert set(rpn.losses) == {"cls", "reg"}
    assert all(np.isfinite(v).all() for v in rpn.losses.values())
    trained = rpn.net.state_dict()
    assert any(not torch.equal(trained[k], start[k]) for k in start)
    ckpts = sorted((tmp_path / "rpn").glob("**/ckpt_*.pth"))
    assert [c.name for c in ckpts] == ["ckpt_00000.pth", "ckpt_00001.pth"]
    assert np.isfinite(rpn.valid_map_bev)  # mode RPN detects no box

    rcnn = ObjectDetection(PointRCNN(**dict(STEP, mode="RCNN")), dataset=ds,
                           device="cpu",
                           main_log_dir=str(tmp_path / "rcnn"), **PIPE)
    rcnn.net.load_state_dict(trained, strict=False)
    rcnn.run_train()
    assert set(rcnn.losses) == {"cls", "reg"}
    assert all(np.isfinite(v).all() for v in rcnn.losses.values())
    assert np.isfinite(rcnn.valid_map_bev) and np.isfinite(rcnn.valid_map_3d)
    after = rcnn.net.state_dict()
    for k, t in trained.items():
        assert torch.equal(after[k], t), k
    assert len(list((tmp_path / "rcnn").glob("**/ckpt_*.pth"))) == 2


def _cli_train_argv(root, logs, mode, db):
    return ["-c", str(PRCNN_YML), "--device", "cpu",
            "--dataset.dataset_path", str(root), "--dataset.val_split", "2",
            "--main_log_dir", str(logs), "--pipeline.num_workers", "0",
            "--pipeline.max_epoch", "0", "--model.mode", mode,
            "--model.npoints", "4096", "--model.rpn.head.nms_pre", "512",
            "--model.rcnn.target_head.num_points", "64",
            "--model.rcnn.target_head.roi_per_image", "16",
            "--model.rpn.head.nms_post_val", "16",
            "--model.augment.ObjectSample.pickle_path", str(db),
            "--split", "train"]


def test_cli_trains_the_shipped_yaml(kitti_root, tmp_path, monkeypatch):
    """``python -m open3d_ml_tpu_torch.run_pipeline -c
    open3d_ml_tpu_torch/configs/pointrcnn_kitti.yml --split train`` at the
    shipped widths (4,096 points, 512 candidates, 64 points a roi, 16
    rois an image in training and validation, to stay quick on the CPU)
    with ObjectSample's database written by
    ``utils/collect_bboxes``: mode RPN (as shipped) then ``--model.mode
    RCNN`` in a log directory of its own, each a finite step, a
    validation and a checkpoint."""
    root = tmp_path / "kitti"
    shutil.copytree(kitti_root, root)
    db = tmp_path / "bboxes.pkl"
    collect_bboxes.collect(KITTI(dataset_path=str(root)), db)
    seen = []
    real = ObjectDetection._train_step

    def train_step(self, inputs):
        losses = real(self, inputs)
        seen.append((self.model.mode, {k: float(v)
                                       for k, v in losses.items()}))
        return losses

    monkeypatch.setattr(ObjectDetection, "_train_step", train_step)
    for mode in ("RPN", "RCNN"):
        logs = tmp_path / mode
        run_pipeline.main(_cli_train_argv(root, logs, mode, db))
        assert len(list(logs.glob("**/ckpt_00000.pth"))) == 1
    assert [m for m, _ in seen] == ["RPN"] * 2 + ["RCNN"] * 2
    assert all(np.isfinite(list(v.values())).all() for _, v in seen)


# ------------------------------------------------------------ chip_smoke

def test_chip_smoke_train_launch_constants():
    """A training step's kernel wrapper calls, counted by ``chip_smoke``'s
    capture on a net of the shipped structure (narrowed, fewer centres):
    mode RPN 12 ``knn_exact`` and 4 ``fps``, mode RCNN 14, 6 and 1
    ``nms_bev``, as ``PRCNN_TRAIN_LAUNCHES`` states."""
    pts = torch.from_numpy(dense_scene(np.random.default_rng(34), b=1, n=N,
                                       far=128))
    for mode in ("RPN", "RCNN"):
        model = PointRCNN(**dict(STEP, mode=mode))
        net = model.get_net().train()
        gt = torch.zeros(1, 24, 7)
        gt[0, 0] = torch.tensor([1.0, 1.0, 2.0, 1.5, 1.6, 3.9, 0.3])
        x = {"point": pts, "bboxes": gt,
             "bbox_count": torch.tensor([1], dtype=torch.int32),
             "labels": torch.zeros(1, N, dtype=torch.int32)}
        if mode == "RPN":
            x["bboxes"] = torch.zeros(1, N, 7)
        calls = chip_smoke._prcnn_calls(net, x, grad=True)[0]
        assert {k: len(v) for k, v in calls.items()} == \
            chip_smoke.PRCNN_TRAIN_LAUNCHES[mode], mode
