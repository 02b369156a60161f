"""PointPillars training in the port (``open3d_ml_tpu_torch``) against the
JAX package, on the CPU.

The small config of ``test_torch_pointpillars.py`` (two classes, so the
class-stacked target order is held); inputs from numpy seeds, the JAX
variables carried across by ``utils/convert_jax.py``. The JAX functions
run as the JAX package runs them on the CPU, through their public entry
points. Tolerances, stated in each test: anchor targets exact but the
deltas (1e-6: XLA's and torch's log differ in the last bit); each loss
1e-6 relative, ``get_loss`` 1e-5; one float32 training step's loss 1e-5,
every gradient 1e-4 relative L2, the BatchNorm statistics after it 1e-5;
the bf16 step (its convolutions summing in float32, as the card's) 1e-3
on the loss, ``BF16_STEP_HEAD`` on the head's gradients and
``BF16_STEP_ANY`` on any, its casts pinned forward and backward; AdamW
1e-6; the augmentation bit-equal.
"""

import collections
import contextlib
import functools
import pickle
import subprocess
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

import chip_smoke
from open3d_ml_tpu.datasets import SyntheticBoxes as JaxSyntheticBoxes
from open3d_ml_tpu.datasets.utils import BEVBox3D as JaxBEVBox3D
from open3d_ml_tpu.datasets.utils import operations as jops
from open3d_ml_tpu.models import PointPillars as JaxPointPillars
from open3d_ml_tpu.models import point_pillars as jpp
from open3d_ml_tpu.modules.losses import CrossEntropyLoss as JaxCE
from open3d_ml_tpu.modules.losses import FocalLoss as JaxFocal
from open3d_ml_tpu.modules.losses import SmoothL1Loss as JaxSmoothL1
from open3d_ml_tpu.utils import Config as JaxConfig
from open3d_ml_tpu_torch.datasets import KITTI, SyntheticBoxes
from open3d_ml_tpu_torch.datasets.synthetic import make_objdet_scene
from open3d_ml_tpu_torch.datasets.utils import BEVBox3D
from open3d_ml_tpu_torch.datasets.utils import operations as tops
from open3d_ml_tpu_torch.models import PointPillars
from open3d_ml_tpu_torch.models import point_pillars as tpp
from open3d_ml_tpu_torch.models.common import BatchNorm
from open3d_ml_tpu_torch.modules.losses import (CrossEntropyLoss, FocalLoss,
                                                SmoothL1Loss)
from open3d_ml_tpu_torch.pipelines import ObjectDetection
from open3d_ml_tpu_torch.utils import collect_bboxes
from open3d_ml_tpu_torch.utils.convert_jax import (jax_to_state_dict,
                                                   load_jax_variables,
                                                   net_layout,
                                                   state_dict_to_jax)

from test_torch_pointpillars import (B, SMALL, apply_rounded, jax_variables,
                                     load_module, point_batch, rel_l2)
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
G = SMALL["max_gt"]
# the augment section of pointpillars_kitti.yml at SMALL's range; the
# database comes in place of the pickle
AUGMENT = {"PointShuffle": True,
           "ObjectRangeFilter": {
               "point_cloud_range": SMALL["point_cloud_range"]},
           "ObjectSample": {
               "pickle_path": None,
               "min_points_dict": {"Car": 5, "Pedestrian": 10,
                                   "Cyclist": 10},
               "sample_dict": {"Car": 15, "Pedestrian": 10,
                               "Cyclist": 10}}}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def anchors(model):
    """SMALL's anchors [H, W, S, R, 7] (16 x 16 cells, 2 sizes, 2
    rotations)."""
    return model._anchors()


def gt_batch(rng, counts=(5, 3)):
    """Random gt boxes inside SMALL's range, Car and Pedestrian sizes,
    padded to max_gt with the pad label."""
    boxes = np.zeros((B, G, 7), np.float32)
    labels = np.full((B, G), len(SMALL["classes"]), np.int32)
    sizes = np.asarray(SMALL["head"]["sizes"], np.float32)
    for b, n in enumerate(counts):
        lbl = rng.integers(0, 2, n)
        boxes[b, :n, 0] = rng.uniform(1, 15, n)
        boxes[b, :n, 1] = rng.uniform(-7, 7, n)
        boxes[b, :n, 2] = np.where(lbl == 0, -1.8, -0.6)
        boxes[b, :n, 3:6] = sizes[lbl] * rng.uniform(0.8, 1.2, (n, 3))
        boxes[b, :n, 6] = rng.uniform(-np.pi, np.pi, n)
        labels[b, :n] = lbl
    return {"bboxes": boxes, "labels": labels,
            "bbox_count": np.asarray(counts, np.int32)}


def planted_targets():
    """Gt boxes that reach every rule of the assignment:

    sample 0: a Car box equal to an anchor; two equal Pedestrian boxes
    of labels 1 and 0 (they tie on every anchor: the argmax anchor goes
    to the later one, the other positives to the first); a small Car box
    on an anchor (its best IoU between the thresholds: rescued); a box
    of the pad label (no class); 3 pad rows.
    sample 1: random boxes."""
    model = PointPillars(**SMALL)
    a = anchors(model)
    out = gt_batch(np.random.default_rng(3))
    car = a[5, 7, 0, 0].copy()
    ped = a[9, 3, 1, 1].copy()
    off = a[12, 11, 0, 1].copy()
    off[3:5] = [1.2, 2.4]  # inside the anchor, 0.42 of its area
    pad_label = a[2, 13, 0, 0].copy()
    out["bboxes"][0, :5] = [car, ped, ped, off, pad_label]
    out["labels"][0, :5] = [0, 1, 0, 0, len(SMALL["classes"])]
    out["bbox_count"][0] = 5
    return out


def port_targets(model, gt):
    with torch.no_grad():
        t = model.assign_bboxes(*[torch.from_numpy(gt[k]) for k in
                                  ("bboxes", "labels", "bbox_count")])
    return {k: v.numpy() for k, v in t.items()}


def jax_targets(gt):
    model = JaxPointPillars(**SMALL)
    t = jax.jit(model.assign_bboxes)(*[jnp.asarray(gt[k]) for k in
                                       ("bboxes", "labels", "bbox_count")])
    return {k: np.asarray(v) for k, v in t.items()}


def assert_targets_equal(got, want):
    """Masks, labels and direction targets exact; deltas within 1e-6."""
    for key in ("pos_mask", "neg_mask", "target_labels", "dir_targets"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["target_deltas"], want["target_deltas"],
                               rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------- assignment

def test_assign_bboxes_planted_cases():
    """Every rule of the matching on planted boxes, the same targets as
    the JAX package's, in the [B, H, W, S, R] order."""
    gt = planted_targets()
    model = PointPillars(**SMALL)
    got, want = port_targets(model, gt), jax_targets(gt)
    assert_targets_equal(got, want)

    h, w, s, r = anchors(model).shape[:4]
    shape = (B, h, w, s, r)
    pos = got["pos_mask"].reshape(shape)
    lbl = got["target_labels"].reshape(shape)
    deltas = got["target_deltas"].reshape(shape + (7,))
    # the Car box equal to anchor (5, 7, Car, 0): deltas 0 there
    assert pos[0, 5, 7, 0, 0] and lbl[0, 5, 7, 0, 0] == 0
    np.testing.assert_allclose(deltas[0, 5, 7, 0, 0], 0, atol=1e-7)
    # the tying Pedestrian boxes: the argmax anchor takes the later box's
    # label 0, the other positives the first box's label 1
    assert pos[0, 9, 3, 1, 1] and lbl[0, 9, 3, 1, 1] == 0
    assert (lbl[0, :, :, 1][pos[0, :, :, 1]] == 1).any()
    # the small Car box is rescued: its best IoU, at anchor (12, 11,
    # Car, 1), lies between the thresholds (0.3, 0.5), yet it is positive
    bev = tpp.box3d_to_bev2d(torch.from_numpy(
        np.stack([gt["bboxes"][0, 3], anchors(model)[12, 11, 0, 1]])))
    iou = tpp.bbox_overlaps(bev[:1], bev[1:]).item()
    assert 0.3 <= iou < 0.5 and model.iou_thr[0] == [0.3, 0.5]
    assert pos[0, 12, 11, 0, 1]
    # the pad-label box: positives of label num_classes
    assert (lbl[0][pos[0]] == len(SMALL["classes"])).any()
    assert not got["neg_mask"].reshape(shape)[0, 5, 7, 0, 0]


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_bboxes_random(seed):
    gt = gt_batch(np.random.default_rng(seed), counts=(G, 2))
    got = port_targets(PointPillars(**SMALL), gt)
    assert_targets_equal(got, jax_targets(gt))
    assert got["pos_mask"].sum() > 0 and got["neg_mask"].sum() > 0


# ---------------------------------------------------------------- losses

def rel(got, want):
    got = got.item() if isinstance(got, torch.Tensor) else float(got)
    return abs(got - float(want)) / abs(float(want))


def test_losses_equal_jax():
    """Each loss against its JAX twin, weighted and normalised, within
    1e-6 relative."""
    rng = np.random.default_rng(5)
    n, c = 400, 3
    pred = rng.normal(0, 2, (n, c)).astype(np.float32)
    target = rng.integers(0, c + 1, n).astype(np.int32)  # c: background
    weight = (rng.uniform(size=n) < 0.7).astype(np.float32)
    avg = np.float32(37.0)
    pairs = [(FocalLoss(gamma=2.0, alpha=0.25, loss_weight=1.0),
              JaxFocal(gamma=2.0, alpha=0.25, loss_weight=1.0),
              (pred, target, weight, avg)),
             (FocalLoss(), JaxFocal(),
              (pred, (target[:, None] == np.arange(c)).astype(np.float32),
               None, None))]
    box_pred = rng.normal(0, 0.3, (n, 7)).astype(np.float32)
    box_target = rng.normal(0, 0.3, (n, 7)).astype(np.float32)
    pairs.append((SmoothL1Loss(beta=0.11, loss_weight=2.0),
                  JaxSmoothL1(beta=0.11, loss_weight=2.0),
                  (box_pred, box_target, weight, avg)))
    pairs.append((SmoothL1Loss(), JaxSmoothL1(),
                  (box_pred, box_target, None, np.float32(0.0))))
    dirs = rng.normal(0, 1, (n, 2)).astype(np.float32)
    dir_t = rng.integers(0, 2, n).astype(np.int32)
    pairs.append((CrossEntropyLoss(loss_weight=0.2), JaxCE(loss_weight=0.2),
                  (dirs, dir_t, weight, avg)))
    for port, ref, args in pairs:
        got = port(*[None if a is None else torch.from_numpy(np.asarray(a))
                     for a in args])
        want = ref(*[None if a is None else jnp.asarray(a) for a in args])
        assert rel(got, want) <= 1e-6, type(port).__name__


def head_outputs(model, seed):
    """Random head outputs [B, H, W, A * x] of SMALL, logits of order 1."""
    rng = np.random.default_rng(seed)
    h, w, s, r = anchors(model).shape[:4]
    a = s * r
    c = len(SMALL["classes"])
    return [rng.normal(0, 1, (B, h, w, a * k)).astype(np.float32)
            for k in (c, 7, 2)]


def test_get_loss_equals_jax():
    """The three loss terms on the planted targets within 1e-5 of the JAX
    package's."""
    model = PointPillars(**SMALL)
    gt = planted_targets()
    outs = head_outputs(model, 7)
    got = model.get_loss([torch.from_numpy(o) for o in outs], to_torch(gt))
    want = jax.jit(JaxPointPillars(**SMALL).get_loss)(
        [jnp.asarray(o) for o in outs], to_jax(gt))
    assert set(got) == {"loss_cls", "loss_bbox", "loss_dir"}
    for key in got:
        assert rel(got[key], want[key]) <= 1e-5, key


def test_get_loss_nan_without_gt_boxes():
    """The JAX package's fault, mirrored: a sample with no gt box matches
    the zero pad box, whose encoded sizes are log(0) = -inf, and the
    smooth-L1 term's inf times its weight 0 is NaN
    (``open3d_ml_tpu/models/point_pillars.py`` ``assign_bboxes``). With a
    gt box in each sample the loss is finite."""
    model, jmodel = PointPillars(**SMALL), JaxPointPillars(**SMALL)
    outs = head_outputs(model, 8)
    for counts, finite in (((2, 1), True), ((2, 0), False)):
        gt = gt_batch(np.random.default_rng(9), counts=counts)
        got = model.get_loss([torch.from_numpy(o) for o in outs],
                             to_torch(gt))
        want = jax.jit(jmodel.get_loss)([jnp.asarray(o) for o in outs],
                                        to_jax(gt))
        assert np.isfinite(float(got["loss_bbox"])) == finite
        assert np.isfinite(float(want["loss_bbox"])) == finite
        assert np.isfinite(float(got["loss_cls"]))


# ------------------------------------------------------------ BatchNorm

@pytest.mark.parametrize("layout", ["1d", "nchw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax(layout, dtype):
    """The shared BatchNorm in train mode against ``flax.linen.BatchNorm``
    (momentum 0.99, eps 1e-3, biased variance): output within 1e-5, the
    moved statistics within 1e-6; [37, 5] rows, or NCHW [2, 5, 6, 7]
    against flax on its NHWC transpose."""
    rng = np.random.default_rng(21)
    shape = (37, 5) if layout == "1d" else (2, 6, 7, 5)  # flax's layout
    x = rng.normal(1.0, 3.0, shape).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 5), rng.normal(0, 0.3, 5)
    mean, var = rng.normal(0, 0.2, 5), rng.uniform(0.5, 1.5, 5)
    variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), {
        "params": {"scale": scale, "bias": bias},
        "batch_stats": {"mean": mean, "var": var}})
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    want, updates = bn.apply(variables, jnp.asarray(x).astype(dtype),
                             mutable=["batch_stats"])
    want = np.asarray(want, np.float32)

    port = BatchNorm(5, eps=1e-3, axis=-1 if layout == "1d" else 1)
    with torch.no_grad():
        for p, v in ((port.weight, scale), (port.bias, bias),
                     (port.running_mean, mean), (port.running_var, var)):
            p.copy_(torch.tensor(v, dtype=torch.float32))
    tx = torch.from_numpy(x if layout == "1d" else x.transpose(0, 3, 1, 2))
    got = port.train()(tx.to(getattr(torch, dtype))).detach().numpy()
    if layout == "nchw":
        got = got.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    stats = updates["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), stats["mean"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(port.running_var.numpy(), stats["var"],
                               rtol=1e-6)


def test_pillar_max_tie_gradient():
    """The bf16 pillar max in train mode splits a tie as JAX's bf16
    segment max does: two points of one pillar whose outputs differ in
    float32 but round to the same bf16 share its gradient; float32
    pooling would hand it all to the larger. Gradients within 1e-6."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (7, 9)).astype(np.float32)
    x[1] = x[0] * np.float32(1 + 2 ** -14)  # the planted tie
    seg = np.array([0, 0, 0, 1, 1, 2, 2], np.int32)  # 2 is dropped
    counts = np.array([3, 2], np.int32)
    kw = dict(num_segments=2, max_pts=3)
    cot = rng.integers(-4, 5, (2, 8)).astype(np.float32)  # bf16-exact

    layer = jpp.PFNLayer(8, last_layer=True, pool_dtype="bfloat16")
    variables = jax_variables(layer, jnp.asarray(x), training=True,
                              seg_ids=jnp.asarray(seg),
                              seg_counts=jnp.asarray(counts), **kw)

    def jloss(xj):
        out, _ = layer.apply(variables, xj, training=True,
                             seg_ids=jnp.asarray(seg),
                             seg_counts=jnp.asarray(counts),
                             mutable=["batch_stats"], **kw)
        return (out.astype(jnp.float32) * cot).sum()

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))

    port = load_module(tpp.PFNLayer(9, 8, pool_dtype="bfloat16"),
                       variables).train()
    tx = torch.from_numpy(x).requires_grad_()
    out = port(tx, seg_ids=torch.from_numpy(seg),
               seg_counts=torch.from_numpy(counts), **kw)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(cot)).sum().backward()
    got = tx.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    # the tie is real: float32 outputs differ, bf16 ones tie and win
    with torch.no_grad():  # the forward's rows: the points and a zero row
        rows = torch.cat([tx, tx.new_zeros((1, 9))])
        y = torch.relu(port.norm(port.linear(rows)))
    tied = (y[0] != y[1]) & (y[0].bfloat16() == y[1].bfloat16())
    assert tied.any()
    assert np.abs(got[0]).sum() > 0 and np.abs(got[1]).sum() > 0


# ------------------------------------------------------- the train step

def train_batch(seed=0):
    rng = np.random.default_rng(seed)
    return dict(point_batch(rng), **gt_batch(rng))


@pytest.fixture(scope="module")
def jax_step():
    """One float32 step of the JAX training net (canvas): variables, loss
    terms, gradients and the moved BatchNorm statistics."""
    batch = train_batch()
    jmodel = JaxPointPillars(**SMALL, compute_dtype="float32")
    net = jmodel.get_net()
    jbatch = to_jax(batch)
    variables = jax_variables(net, jbatch, training=False)

    def loss_fn(params):
        out, upd = net.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jbatch, training=True, mutable=["batch_stats"])
        losses = jmodel.get_loss(out, jbatch)
        return sum(losses.values()), (upd["batch_stats"], losses)

    (loss, (stats, losses)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return {"batch": batch, "variables": variables, "loss": float(loss),
            "losses": {k: float(v) for k, v in losses.items()},
            "grads": jax.tree.map(np.asarray, grads),
            "stats": jax.tree.map(np.asarray, stats)}


def test_train_step_float32(jax_step):
    """The port's training net (canvas, float32) in train mode, the same
    variables and batch: the loss within 1e-5 relative, every parameter's
    gradient within 1e-4 relative L2, every BatchNorm statistic after the
    step within 1e-5 relative L2 of the JAX package's."""
    model = PointPillars(**SMALL, compute_dtype="float32")
    net = load_jax_variables(model.get_net(), jax_step["variables"]).train()
    batch = to_torch(jax_step["batch"])
    losses = model.get_loss(net(batch), batch)
    total = sum(losses.values())
    total.backward()
    assert rel(total, jax_step["loss"]) <= 1e-5
    for key, value in losses.items():
        assert rel(value, jax_step["losses"][key]) <= 1e-5, key

    layout = net_layout(net)
    grads = state_dict_to_jax({k: p.grad for k, p in net.named_parameters()},
                              **layout)["params"]
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(jax_step["grads"]))
    got = dict(flat(grads))
    assert set(got) == set(want)
    for path, g in got.items():
        assert rel_l2(g, want[path]) <= 1e-4, path
    stats = state_dict_to_jax(net.state_dict(), **layout)["batch_stats"]
    want = dict(flat(jax_step["stats"]))
    for path, value in flat(stats):
        assert rel_l2(value, want[path]) <= 1e-5, path
    # the statistics moved: the test would see the old ones
    old = dict(flat(jax_step["variables"]["batch_stats"]))
    assert any(rel_l2(v, old[p]) > 1e-3 for p, v in want.items())


def test_adamw_equals_optax(jax_step):
    """Two AdamW steps of ``get_optimizer`` on the same parameters and
    gradients as ``optax.adamw`` from the JAX ``get_optimizer`` (the
    KITTI pipeline's lr, betas and weight decay): every parameter within
    1e-6 relative L2, each having moved by more than 1e-4 somewhere. No
    gradient is
    clipped, though ``grad_clip_norm`` is set, as the JAX pipeline
    ignores it."""
    cfg = {"optimizer": {"lr": 0.001, "betas": [0.95, 0.99],
                         "weight_decay": 0.01}, "grad_clip_norm": 2}
    model = PointPillars(**SMALL, compute_dtype="float32")
    net = load_jax_variables(model.get_net(), jax_step["variables"])
    optimizer, scheduler = model.get_optimizer(cfg, net)
    assert scheduler is None
    assert len(optimizer.param_groups[0]["params"]) == \
        len(list(net.parameters()))
    tx, _ = JaxPointPillars(**SMALL).get_optimizer(JaxConfig(cfg))
    params = jax_step["variables"]["params"]
    state = tx.init(params)
    layout = net_layout(net)
    for step in range(2):
        grads = jax.tree.map(lambda g: g * (10.0 if step else 1.0),
                             jax_step["grads"])  # one beyond the clip norm
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        torch_grads = jax_to_state_dict({"params": grads}, **layout)
        for name, p in net.named_parameters():
            p.grad = torch_grads[name].clone()
        optimizer.step()
    got = state_dict_to_jax(net.state_dict(), **layout)["params"]
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(params))
    start = dict(flat(jax_step["variables"]["params"]))
    for path, value in flat(got):
        assert rel_l2(value, want[path]) <= 1e-6, path
        assert np.abs(value - start[path]).max() > 1e-4, path


# ---------------------------------------------------- the bf16 train step

JAX_BF16 = JaxPointPillars(**SMALL, compute_dtype="bfloat16")
JAX_BF16_NET = JAX_BF16.get_net()
HEAD = ("conv_cls", "conv_reg", "conv_dir_cls")
# The bf16 step against the JAX step, relative L2 of each gradient, over
# batch and weight seeds 0-9 (test_train_step_bfloat16): the sound port
# reads at most 7.30e-3 on the head's gradients and 0.238 on any; BN in
# bf16 reads 1.39e-2 and more on the head, the first convolution in
# float32 1.27e-2 and more. The other gradients lie far apart even when
# sound: a bf16 rounding that the sums' order flips in the forward moves
# them through the backward of train-mode BatchNorm (the JAX step's own
# float32 and bf16 backbone gradients lie 0.07-0.26 apart, seed 0).
BF16_STEP_HEAD = 1e-2
BF16_STEP_ANY = 0.5


def jax_bf16_step(variables, batch):
    """(loss, gradients) of one step of the JAX training net (canvas,
    bf16), each bf16 convolution's output rounded."""
    def loss_fn(params):
        out, _ = apply_rounded(
            JAX_BF16_NET, {"params": params,
                           "batch_stats": variables["batch_stats"]},
            batch, training=True, mutable=["batch_stats"])
        return sum(JAX_BF16.get_loss(out, batch).values())

    return jax.value_and_grad(loss_fn)(variables["params"])


jax_bf16_step = jax.jit(jax_bf16_step)


class _CardConvs:
    """``torch.nn.functional`` whose bf16 convolutions take their bf16
    operands in float32 and round the output to bf16, as the card's do
    (cuDNN accumulates in float32). The CPU's own bf16 convolution
    backward is far less exact: at seed 0 its backbone and PFN gradients
    lie 0.45-1.47 (relative L2) from the float32 step's, against
    0.11-0.40 with float32 sums, which is what the JAX step reads."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def conv2d(x, w, *args, **kwargs):
        if x.dtype != torch.bfloat16:
            return F.conv2d(x, w, *args, **kwargs)
        return F.conv2d(x.float(), w.float(), *args, **kwargs).bfloat16()

    @staticmethod
    def conv_transpose2d(x, w, *args, **kwargs):
        if x.dtype != torch.bfloat16:
            return F.conv_transpose2d(x, w, *args, **kwargs)
        return F.conv_transpose2d(x.float(), w.float(), *args,
                                  **kwargs).bfloat16()


def _bn_bf16_train(bn, x):
    return F.batch_norm(x.bfloat16(), None, None, bn.weight.bfloat16(),
                        bn.bias.bfloat16(), True, 0.0, bn.eps)


@contextlib.contextmanager
def planted_train_cast(net, fault):
    """The training net with one wrong cast while the context lasts:
    "bn_bf16", the backbone's and the neck's BatchNorms computing their
    batch statistics and output in bf16; else a fault of
    ``chip_smoke.planted_cast`` ("canvas_f32": the pillar max in float32;
    a convolution's name: that convolution in float32); None: none."""
    if fault != "bn_bf16":
        with (chip_smoke.planted_cast(net, fault) if fault else
              contextlib.nullcontext()):
            yield net
        return
    with contextlib.ExitStack() as stack:
        for name, m in net.named_modules():
            if name.startswith(("backbone.", "neck.")) and \
                    isinstance(m, BatchNorm):
                stack.enter_context(mock.patch.object(
                    m, "forward", functools.partial(_bn_bf16_train, m)))
        yield net


@pytest.mark.parametrize("seed", range(10))
def test_train_step_bfloat16(seed, capsys):
    """The port's training net at bf16 (the serving net in train mode),
    its convolutions summing in float32 as the card's do (``_CardConvs``),
    against ``jax.value_and_grad`` on the JAX net with its bf16
    convolutions' outputs rounded, the same variables and batch of seed
    ``seed``: the loss within 1e-3 relative, the head's gradients within
    ``BF16_STEP_HEAD`` and every gradient within ``BF16_STEP_ANY``
    relative L2. BN in bf16 and the first convolution in float32, planted,
    read past ``BF16_STEP_HEAD``; the faults that no gradient bound
    separates from a flipped rounding are held by the cast pin
    (``test_train_step_bfloat16_casts``)."""
    batch = train_batch(seed)
    jbatch = to_jax(batch)
    variables = jax_variables(JAX_BF16_NET, jbatch, seed=seed,
                              training=False)
    loss, grads = jax_bf16_step(variables, jbatch)
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, grads)))
    readings = {}
    for fault in (None, "bn_bf16", "backbone.block0_conv0"):
        model = PointPillars(**SMALL)
        net = load_jax_variables(model.get_net(), variables)
        with planted_train_cast(net, fault), \
                mock.patch.object(tpp, "F", _CardConvs()):
            total, got = port_step(model, net, to_torch(batch))
        r = {path: rel_l2(g, want[path]) for path, g in got.items()}
        readings[fault] = (rel(total, loss),
                           max(v for p, v in r.items() if p[0].key in HEAD),
                           max(r.values()))
    with capsys.disabled():
        print(f"\nseed {seed}: " + "; ".join(
            f"{k or 'sound'} loss {a:.2e} head {h:.2e} any {m:.2e}"
            for k, (a, h, m) in readings.items()))
    loss_rel, head, worst = readings[None]
    assert loss_rel <= 1e-3
    assert head <= BF16_STEP_HEAD and worst <= BF16_STEP_ANY
    for fault in ("bn_bf16", "backbone.block0_conv0"):
        assert readings[fault][1] > BF16_STEP_HEAD, fault


class _TrainCastLog(TorchDispatchMode):
    """Records the dtypes of every convolution of a forward and a backward
    (input, weight; and the cotangent in the backward) and whether it has
    a bias (the head's)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.calls.append(("forward", args[2] is not None,
                               (args[0].dtype, args[1].dtype)))
        elif func is torch.ops.aten.convolution_backward.default:
            self.calls.append(("backward", list(args[3] or [0]) != [0],
                               (args[0].dtype, args[1].dtype,
                                args[2].dtype)))
        return func(*args, **(kwargs or {}))


def train_cast_faults(model, net, batch):
    """The places in one training step of the bf16 net where a dtype breaks
    the cast contract: the pillar max and the canvas in bf16, every
    BatchNorm's output in float32, each backbone and neck convolution's
    forward and backward on bf16 operands and cotangents, the head's in
    float32. Empty when the step keeps it."""
    bf16, f32 = torch.bfloat16, torch.float32
    outs = {}

    def record(name, module, args, out):
        outs[name] = out.dtype

    hooks = [net.voxel_encoder.register_forward_hook(
        functools.partial(record, "canvas"))]
    hooks += [m.register_forward_hook(functools.partial(record, name))
              for name, m in net.named_modules() if isinstance(m, BatchNorm)]
    log = _TrainCastLog()
    try:
        with log:
            sum(model.get_loss(net.train()(batch), batch).values()).backward()
    finally:
        for hook in hooks:
            hook.remove()
    faults = [f"{k} {v}" for k, v in outs.items()
              if v != (bf16 if k == "canvas" else f32)]
    for i, (kind, head, dtypes) in enumerate(log.calls):
        if set(dtypes) != {f32 if head else bf16}:
            faults.append(f"{kind} #{i} on {dtypes}")
    convs = len(chip_smoke.pp_convs(net))
    counts = collections.Counter(kind for kind, _, _ in log.calls)
    if counts != {"forward": convs + 3, "backward": convs + 3}:
        faults.append(f"calls {dict(counts)}")
    return faults


SMALL_CONVS = tuple(chip_smoke.pp_convs(PointPillars(**SMALL).get_net()))


@pytest.mark.parametrize("fault", (None, "bn_bf16", "canvas_f32") +
                         SMALL_CONVS)
def test_train_step_bfloat16_casts(fault):
    """The bf16 training step's casts (``train_cast_faults``), forward and
    backward: none broken in the sound net, and each planted fault (BN in
    bf16, the pillar max in float32, one convolution in float32) caught.
    In torch a gradient takes its tensor's dtype, so a convolution whose
    forward runs in bf16 runs its backward in bf16 too; the pin reads the
    backward all the same."""
    model = PointPillars(**SMALL)
    net = model.get_net()
    batch = to_torch(train_batch(0))
    with planted_train_cast(net, fault):
        faults = train_cast_faults(model, net, batch)
    assert bool(faults) == (fault is not None), faults


# --------------------------------------------------------- augmentation

def database(split, ops, box_type):
    """{class: boxes with their points} of every frame of ``split``, the
    boxes made by ``box_type`` and filled by ``ops.points_in_box``, kept
    as ``load_gt_database`` keeps them (at least the class's min
    points)."""
    sample = AUGMENT["ObjectSample"]
    db = {k: [] for k in sample["sample_dict"]}
    for i in range(len(split)):
        data = split.get_data(i)
        boxes = [box_type(b.center, b.size, b.yaw, b.label_class, -1.0)
                 for b in data["bounding_boxes"]]
        inside = ops.points_in_box(data["point"],
                                   [b.to_xyzwhlr() for b in boxes])
        for j, box in enumerate(boxes):
            box.points_inside_box = data["point"][inside[:, j]]
            if (box.points_inside_box.shape[0] >=
                    sample["min_points_dict"][box.label_class]):
                db[box.label_class].append(box)
    return db


@pytest.fixture(scope="module")
def databases():
    port = database(SyntheticBoxes(seed=2).get_split("training"), tops,
                    BEVBox3D)
    ref = database(JaxSyntheticBoxes(seed=2).get_split("training"), jops,
                   JaxBEVBox3D)
    return port, ref


def assert_same_boxes(got, want):
    assert [b.label_class for b in got] == [b.label_class for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.to_xyzwhlr(), w.to_xyzwhlr())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_train_preprocess_bit_equal(seed, databases):
    """The train split's ``preprocess`` (range filter, then ObjectSample,
    ObjectRangeFilter and PointShuffle from the model's generator) and
    ``transform`` bit-equal to the JAX package's, and the generator in
    the same state after; each database built in its package from the
    same frames."""
    db, jdb = databases
    port = PointPillars(**SMALL, augment=AUGMENT)
    ref = JaxPointPillars(**SMALL, augment=AUGMENT)
    port.augmenter.db_boxes_dict, ref.augmenter.db_boxes_dict = db, jdb
    port.rng = np.random.default_rng(seed)
    ref.rng = np.random.default_rng(seed)
    attr = {"split": "training"}
    data = SyntheticBoxes(seed=5).get_split("validation").get_data(seed % 2)
    jdata = JaxSyntheticBoxes(seed=5).get_split("validation").get_data(
        seed % 2)
    got = port.preprocess(data, attr)
    want = ref.preprocess(jdata, attr)
    np.testing.assert_array_equal(got["point"], want["point"])
    assert_same_boxes(got["bbox_objs"], want["bbox_objs"])
    scene = {tuple(b.to_xyzwhlr()) for b in data["bounding_boxes"]}
    assert any(tuple(b.to_xyzwhlr()) not in scene for b in got["bbox_objs"])
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state
    got_t, want_t = port.transform(got, attr), ref.transform(want, attr)
    for key in ("point", "point_count", "bboxes", "labels", "bbox_count"):
        np.testing.assert_array_equal(got_t[key], want_t[key], err_msg=key)


def test_sample_class_and_collisions_bit_equal(databases):
    db, jdb = databases
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    gt, jgt = db["Car"][:3], jdb["Car"][:3]
    coll = tops.box_collision_test(db["Car"], db["Pedestrian"])
    np.testing.assert_array_equal(
        coll, jops.box_collision_test(jdb["Car"], jdb["Pedestrian"]))
    for name, num in (("Car", 15), ("Pedestrian", 10), ("Cyclist", 4)):
        got = tops.sample_class(name, num, gt, db[name], rng=rng)
        want = jops.sample_class(name, num, jgt, jdb[name], rng=jrng)
        assert_same_boxes(got, want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.points_inside_box,
                                          w.points_inside_box)
    assert rng.bit_generator.state == jrng.bit_generator.state
    assert tops.random_sample(db["Car"][:2], 5, rng) == db["Car"][:2]


def test_gt_database_writer(tmp_path):
    """``python -m open3d_ml_tpu_torch.utils.collect_bboxes`` on KITTI
    frames: every frame's boxes with the points the JAX
    ``points_in_box`` finds inside; the pickle loads (through
    ``load_gt_database``) in a process that imports neither JAX nor the
    JAX package."""
    for i in range(3):
        chip_smoke.write_kitti_frame(tmp_path, "training", i, 30 + i)
    out = collect_bboxes.main(["--dataset_path", str(tmp_path)])
    with open(out, "rb") as f:
        boxes = pickle.load(f)
    split = KITTI(dataset_path=str(tmp_path)).get_split("train")
    want = []
    for i in range(len(split)):
        data = split.get_data(i)
        inside = jops.points_in_box(
            data["point"], [b.to_xyzwhlr() for b in data["bounding_boxes"]])
        want += [data["point"][inside[:, j]]
                 for j in range(len(data["bounding_boxes"]))]
    assert len(boxes) == len(want) == 36
    for box, points in zip(boxes, want):
        np.testing.assert_array_equal(box.points_inside_box, points)
    assert sum(len(p) for p in want) > 0

    code = ("import sys\n"
            "from open3d_ml_tpu_torch.datasets.augment import "
            "ObjdetAugmentation\n"
            f"db = ObjdetAugmentation.load_gt_database({str(out)!r}, "
            "{'Car': 5}, {'Car': 15, 'Pedestrian': 10})\n"
            "assert db['Car'] and not db['Pedestrian'], db\n"
            "assert all(len(b.points_inside_box) >= 5 for b in db['Car'])\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'open3d_ml_tpu')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# --------------------------------------------------------------- run_train

def test_run_train_resume_and_valid(tmp_path):
    """``run_train`` on ``SyntheticBoxes`` with ObjectSample on a database
    the port's writer built: one batch drawn before the epochs, as the JAX
    pipeline draws it, then 2 epochs of 2 steps with finite losses, a
    checkpoint each epoch and ``run_valid`` from the trained net; a fresh
    pipeline resumes from the newest checkpoint with its weights and
    BatchNorm statistics and with AdamW started afresh, as the JAX
    pipeline resumes (it saves ``opt_state`` but never restores it)."""
    classes = ["Pedestrian", "Cyclist", "Car"]
    cfg = dict(SMALL, classes=classes,
               point_cloud_range=[0, -16, -3, 32, 16, 1],
               voxelize=dict(SMALL["voxelize"], voxel_size=[1.0, 1.0, 4]),
               head=dict(SMALL["head"],
                         ranges=[[0, -16, -0.6, 32, 16, -0.6]] * 2 +
                         [[0, -16, -1.78, 32, 16, -1.78]],
                         sizes=[[0.6, 0.8, 1.73], [0.6, 1.76, 1.73],
                                [1.6, 3.9, 1.56]]))
    ds = SyntheticBoxes(dataset_path=str(tmp_path), seed=0,
                        num_clouds={"training": 4, "validation": 1,
                                    "test": 1})
    assert collect_bboxes.collect(ds, tmp_path / "bboxes.pkl") == 48
    augment = dict(AUGMENT, ObjectRangeFilter={
        "point_cloud_range": cfg["point_cloud_range"]},
        ObjectSample=dict(AUGMENT["ObjectSample"],
                          pickle_path=str(tmp_path / "bboxes.pkl")))
    pipe_cfg = dict(batch_size=2, max_epoch=1, save_ckpt_freq=5,
                    num_workers=1, overlaps=[0.1, 0.1, 0.2],
                    difficulties=[0], main_log_dir=str(tmp_path / "logs"))
    model = PointPillars(**cfg, augment=augment, seed=0)
    pipe = ObjectDetection(model, dataset=ds, device="cpu", seed=0,
                           **pipe_cfg)
    start = {k: v.clone() for k, v in pipe.net.state_dict().items()}
    first = []
    step = pipe._train_step
    pipe._train_step = lambda x: first.append(x["point"].clone()) or step(x)
    pipe.run_train()
    # as the JAX pipeline, one batch drawn before the epochs: the first
    # step trains on the first frames drawn a second time from a fresh
    # model's generator
    fresh = ObjectDetection(PointPillars(**cfg, augment=augment, seed=0),
                            dataset=ds, device="cpu", seed=0, **pipe_cfg)
    draws = [next(iter(fresh._loader("training", 2, num_workers=0)))
             ["data"]["point"] for _ in range(2)]
    assert torch.equal(first[0], torch.from_numpy(draws[1]))
    assert not np.array_equal(draws[0], draws[1])
    assert set(pipe.losses) == {"loss_cls", "loss_bbox", "loss_dir"}
    assert all(len(v) == 2 and np.isfinite(v).all()
               for v in pipe.losses.values())
    assert np.isfinite(pipe.valid_map_bev) and np.isfinite(pipe.valid_map_3d)
    ckpts = sorted((Path(pipe.cfg.logs_dir) / "checkpoint").glob("*.pth"))
    assert [c.name for c in ckpts] == ["ckpt_00000.pth", "ckpt_00001.pth"]
    trained = pipe.net.state_dict()
    assert not torch.equal(trained["conv_cls.weight"],
                           start["conv_cls.weight"])
    assert not torch.equal(trained["backbone.block0_bn0.running_var"],
                           start["backbone.block0_bn0.running_var"])
    assert pipe.optimizer.state_dict()["state"]

    resumed = ObjectDetection(model, dataset=ds, device="cpu", seed=1,
                              **dict(pipe_cfg, max_epoch=2))
    seen = {}
    load = resumed.load_ckpt

    def checked(*args, **kwargs):
        epoch = load(*args, **kwargs)
        seen["epoch"] = epoch
        for key, value in resumed.net.state_dict().items():
            assert torch.equal(value, trained[key]), key
        assert resumed.optimizer.state_dict()["state"] == {}
        return epoch

    resumed.load_ckpt = checked
    resumed.run_train()
    assert seen["epoch"] == 2
    assert all(len(v) == 2 for v in resumed.losses.values())
    saved = torch.load(ckpts[-1], weights_only=True)
    assert saved["epoch"] == 1 and saved["optimizer"]["state"]


def test_chip_smoke_training_config_equals_shipped_yaml():
    """``chip_smoke.py``'s augment section (but for the pickle, written at
    run time) and training pipeline entries are the KITTI YAML's."""
    cfg = JaxConfig.load_from_file(
        REPO / "open3d_ml_tpu_torch/configs/pointpillars_kitti.yml")
    assert cfg.to_dict() == JaxConfig.load_from_file(
        REPO / "open3d_ml_tpu/configs/pointpillars_kitti.yml").to_dict()
    augment = cfg.model.augment.to_dict()
    augment["ObjectSample"]["pickle_path"] = None
    assert chip_smoke.POINTPILLARS_AUGMENT == augment
    for key, value in chip_smoke.POINTPILLARS_TRAIN_PIPELINE.items():
        want = cfg.pipeline[key]
        assert (want.to_dict() if hasattr(want, "to_dict") else want) == \
            value, key


def port_step(model, net, batch):
    """(total loss, {flax path: gradient}) of one port training step."""
    total = sum(model.get_loss(net.train()(batch), batch).values())
    total.backward()
    grads = state_dict_to_jax({k: p.grad for k, p in net.named_parameters()},
                              **net_layout(net))["params"]
    return total.item(), dict(jax.tree_util.tree_leaves_with_path(grads))


@pytest.mark.slow
def test_kitti_train_step_full_width(monkeypatch):
    """The shipped KITTI config's training net (canvas, float32) for one
    step at B=1 on a ``make_objdet_scene`` frame with its boxes, from the
    weights ``ObjectDetection`` draws (``init_weights``, seed 0): the anchor
    targets exact but the deltas (1e-6), the loss within 1e-5 relative,
    the gradients of the head and of the neck's BatchNorms within 1e-4
    relative L2 each.

    The other gradients (those of the backbone, the PFN and the neck's
    transposed convolutions, which multiply the backbone's outputs) are
    held another way. At this
    size the float32 backward through train-mode BatchNorm over the mostly
    empty canvas is ill-conditioned: both packages' float32 gradients of
    the first layers lie some 3e-3 to 7e-3 (relative L2) from the same
    step run in float64 by the port, in different directions. So each of
    them must be within 2e-2 of JAX's, and no farther from the float64
    step than twice JAX's distance from it (or 1e-4)."""
    from open3d_ml_tpu_torch.pipelines.semantic_segmentation import \
        init_weights
    cfg = JaxConfig.load_from_file(
        REPO / "open3d_ml_tpu_torch/configs/pointpillars_kitti.yml")
    assert cfg.to_dict() == JaxConfig.load_from_file(
        REPO / "open3d_ml_tpu/configs/pointpillars_kitti.yml").to_dict()
    kw = {k: v for k, v in cfg.model.to_dict().items()
          if k not in ("name", "ckpt_path", "augment")}
    kw["compute_dtype"] = "float32"
    port, ref = PointPillars(**kw), JaxPointPillars(**kw)
    points, boxes = make_objdet_scene(42)
    data = {"point": points, "calib": None, "bounding_boxes": [
        BEVBox3D(b["center"], b["size"], b["yaw"], b["label_class"], -1.0)
        for b in boxes]}
    attr = {"split": "validation"}  # range filter, no augmentation
    sample = port.transform(port.preprocess(data, attr), attr)
    batch = {k: np.asarray(sample[k])[None] for k in
             ("point", "point_count", "bboxes", "labels", "bbox_count")}
    tnet = init_weights(port.get_net(), torch.Generator().manual_seed(0))
    state = tnet.state_dict()
    variables = state_dict_to_jax(state, **net_layout(tnet))
    jbatch = to_jax(batch)
    net = ref.get_net()

    def loss_fn(params):
        out, _ = net.apply({"params": params,
                            "batch_stats": variables["batch_stats"]},
                           jbatch, training=True, mutable=["batch_stats"])
        return sum(ref.get_loss(out, jbatch).values())

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    want = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, grads)))
    total, got = port_step(port, tnet, to_torch(batch))
    assert rel(total, loss) <= 1e-5

    # the same step in float64: every float32 cast of the net and the
    # losses made a float64 one
    monkeypatch.setitem(tpp._DTYPES, "float32", torch.float64)
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    model64 = PointPillars(**kw)
    net64 = model64.get_net()
    net64.load_state_dict(state)
    batch64 = {k: v.double() if v.is_floating_point() else v
               for k, v in to_torch(batch).items()}
    _, exact = port_step(model64, net64.double(), batch64)
    monkeypatch.undo()
    for path, g in got.items():
        if path[0].key.startswith("conv_") or path[1].key.endswith("_bn"):
            assert rel_l2(g, want[path]) <= 1e-4, path
        assert rel_l2(g, want[path]) <= 2e-2, path
        assert rel_l2(g, exact[path]) <= max(
            2 * rel_l2(want[path], exact[path]), 1e-4), path

    gt = {k: batch[k] for k in ("bboxes", "labels", "bbox_count")}
    with torch.no_grad():
        t = port.assign_bboxes(*[torch.from_numpy(gt[k]) for k in
                                 ("bboxes", "labels", "bbox_count")])
    jt = jax.jit(ref.assign_bboxes)(*[jnp.asarray(gt[k]) for k in
                                      ("bboxes", "labels", "bbox_count")])
    assert_targets_equal({k: v.numpy() for k, v in t.items()},
                         {k: np.asarray(v) for k, v in jt.items()})
    assert t["pos_mask"].sum() > 0
