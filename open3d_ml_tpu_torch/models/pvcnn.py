"""PVCNN (Point-Voxel CNN) for semantic segmentation.

Counterpart of ``open3d_ml_tpu/models/pvcnn.py``: a PointNet trunk whose
PVConv blocks add a point branch (a shared MLP) to a voxel branch, which
averages the points' features into an r^3 grid of the sample's own
normalised frame (``voxelize_normalized``), runs two 3D convolutions over
it and reads it back at the points by trilinear interpolation
(``ops/cuda/devoxelize.py`` ``trilinear_devoxelize``: its kernel pair on
a card); then a global feature (the max over the points
and two Linear-BatchNorm-ReLU layers) and the classifier over the
concatenation of every block's output and the global feature.

The JAX net runs one sample at a time under ``nn.vmap`` with every
BatchNorm's statistics taken over the whole batch; here the net takes the
[B, N, .] batch at once. Each sample is voxelised in its own frame (its
own mean and scale), the voxel BatchNorms reduce over B * r^3 cells, the
point ones over B * N points and the global feature's over B, as the
vmapped ``axis_name="batch"`` gives them. The voxel branch is
channels-last, flax's NDHWC: the grid is [B, r, r, r, C] in memory and
the ``Conv3d``s take it as [B, C, r, r, r] in ``torch.channels_last_3d``,
which is how they return it, so the devoxelisation reads each corner's
channels contiguously.

The parameter names follow the JAX variable tree (``pf{i}`` with
``vconv{j}``, ``vbn{j}`` and ``point_features.dense_0``/``bn_0`` or, for
the last block, ``dense_0``/``bn_0``; ``cloud{j}``, ``cloud_bn{j}``,
``cls0``, ``cls1``, ``cls2``), so ``utils/convert_jax.py`` maps one onto
the other, and ``utils/convert_torch.py`` ``convert_pvcnn`` maps the
reference's checkpoints. The BatchNorms use torch's momentum 0.1 (flax's
0.9) and eps 1e-5, the voxel ones eps 1e-4. The two dropouts (0.3) draw
their masks from one generator of their own (``common.Dropout``).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..datasets.augment import SemsegAugmentation
from ..modules.losses import filter_valid_label
from ..modules.schedulers import exponential_lr
from ..ops.cuda import devoxelize as cdv
from ..utils.registry import MODEL
from .base_model import BaseModel
from .common import BatchNorm, Dropout

BN_MOMENTUM = 0.1  # torch's; flax's 0.9
# (out_channels, num_blocks, voxel_resolution) of the trunk, before the
# width and resolution multipliers; None: a shared MLP, no voxel branch
BLOCKS = ((64, 1, 32), (64, 2, 16), (128, 1, 16), (1024, 1, None))


def voxel_cells(norm):
    """The cell of each voxel-unit coordinate: round half to even, as
    ``jnp.round``."""
    return torch.round(norm).long()


def cloud_max(feat):
    """The global feature: the max over the points, [B, N, C] -> [B, C]
    (``amax``: its gradient split evenly among tied points, as JAX's)."""
    return feat.amax(dim=1)


def avg_voxelize(feat, vox_coords, r):
    """Mean of the point features in each voxel cell of each sample: feat
    [B, N, C], vox_coords [B, N, 3] int in [0, r) -> [B, r, r, r, C]
    (channels-last, contiguous), a cell without points 0. The cell of
    (x, y, z) is the flat index (x * r + y) * r + z, so ``grid[b, x, y,
    z]`` is the cell that the devoxelisation reads there."""
    b, n, c = feat.shape
    cells = r ** 3
    hash_ = ((vox_coords[..., 0] * r + vox_coords[..., 1]) * r +
             vox_coords[..., 2])
    hash_ = (hash_ + torch.arange(b, device=feat.device)[:, None] *
             cells).reshape(-1)
    grid = torch.zeros((b * cells, c), dtype=feat.dtype, device=feat.device)
    grid = grid.index_add(0, hash_, feat.reshape(-1, c))
    count = torch.zeros((b * cells, 1), dtype=feat.dtype, device=feat.device)
    count = count.index_add(0, hash_, torch.ones((b * n, 1), dtype=feat.dtype,
                                                 device=feat.device))
    return (grid / torch.clamp(count, min=1.0)).reshape(b, r, r, r, c)


def voxelize_normalized(features, coords, r, normalize=True, eps=1e-6):
    """Each sample's points recentred on their mean and, with
    ``normalize``, scaled into [0, 1] by twice the largest distance from
    the mean (sqrt of the sum of squares, as XLA computes the norm), or
    else mapped from [-1, 1]; then into voxel units clipped to [0, r - 1],
    rounded to their cells and average-voxelised. features [B, N, C],
    coords [B, N, 3] (no gradient) -> (grid [B, r, r, r, C], the
    voxel-unit coordinates [B, N, 3])."""
    coords = coords.detach()
    norm = coords - coords.mean(dim=1, keepdim=True)
    if normalize:
        dist = torch.sqrt((norm * norm).sum(-1))
        scale = dist.amax(dim=1)[:, None, None] * 2.0 + eps
        norm = norm / scale + 0.5
    else:
        norm = (norm + 1) / 2.0
    norm = torch.clamp(norm * r, 0, r - 1)
    return avg_voxelize(features, voxel_cells(norm), r), norm


class SharedMLP(nn.Module):
    """Linear, BatchNorm (eps 1e-5, over every point of the batch) and
    ReLU, for each width of ``out_channels``, over [..., C]."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        chans = (tuple(out_channels) if isinstance(out_channels, (tuple, list))
                 else (out_channels,))
        self.widths = chans
        for i, oc in enumerate(chans):
            self.add_module(f"dense_{i}", nn.Linear(in_channels, oc))
            self.add_module(f"bn_{i}", BatchNorm(oc, eps=1e-5,
                                                 momentum=BN_MOMENTUM))
            in_channels = oc

    def forward(self, x):
        for i in range(len(self.widths)):
            x = getattr(self, f"dense_{i}")(x)
            x = F.relu(getattr(self, f"bn_{i}")(x))
        return x


class SE3d(nn.Module):
    """Squeeze-excitation gate over a voxel grid's channels: the grid
    [B, C, r, r, r] times sigmoid(fc1(relu(fc0(its mean over the cells))))
    per sample. No shipped net uses it."""

    def __init__(self, channel, reduction=8):
        super().__init__()
        self.fc0 = nn.Linear(channel, channel // reduction, bias=False)
        self.fc1 = nn.Linear(channel // reduction, channel, bias=False)

    def forward(self, x):
        s = x.mean(dim=(2, 3, 4))
        s = torch.sigmoid(self.fc1(F.relu(self.fc0(s))))
        return x * s[:, :, None, None, None]


class PVConv(nn.Module):
    """Point-voxel convolution: the voxel branch (``voxelize_normalized``,
    two 3D convolutions of ``kernel_size`` with bias, each followed by
    BatchNorm over B * r^3 cells, eps 1e-4, and LeakyReLU 0.1, the SE
    gate where ``with_se``, then the devoxelisation at the points) plus the
    point branch (``SharedMLP``)."""

    def __init__(self, in_channels, out_channels, resolution, kernel_size=3,
                 with_se=False, normalize=True, eps=1e-6):
        super().__init__()
        self.resolution = resolution
        self.normalize = normalize
        self.eps = eps
        cin = in_channels
        for i in range(2):
            self.add_module(f"vconv{i}", nn.Conv3d(
                cin, out_channels, kernel_size, padding=kernel_size // 2))
            self.add_module(f"vbn{i}", BatchNorm(
                out_channels, eps=1e-4, momentum=BN_MOMENTUM, axis=1))
            cin = out_channels
        self.se = SE3d(out_channels) if with_se else None
        self.point_features = SharedMLP(in_channels, (out_channels,))

    def forward(self, features, coords):
        """features [B, N, Cin], coords [B, N, 3] -> [B, N, Cout]."""
        grid, norm = voxelize_normalized(features, coords, self.resolution,
                                         self.normalize, self.eps)
        x = grid.permute(0, 4, 1, 2, 3)  # [B, C, r, r, r], channels-last
        for i in range(2):
            x = getattr(self, f"vbn{i}")(getattr(self, f"vconv{i}")(x))
            x = F.leaky_relu(x, 0.1)
        if self.se is not None:
            x = self.se(x)
        # the layout the devoxelisation reads. cuDNN keeps channels-last,
        # and on the card a grid in any other layout raises in the
        # devoxelisation rather than being copied; PyTorch's CPU
        # convolution returns NCDHW at B = 1, which the plain version
        # takes after this copy
        if not x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last_3d)
        vox = cdv.trilinear_devoxelize(x.permute(0, 2, 3, 4, 1), norm)
        return vox + self.point_features(features)


class PVCNNNet(nn.Module):
    """The PVCNN network over a [B, N, .] batch: ``inputs["point"]``
    [B, N, 3] and ``inputs["feat"]`` [B, N, in_channels] -> logits
    [B, N, num_classes]."""

    def __init__(self, num_classes, in_channels, width_multiplier=1,
                 voxel_resolution_multiplier=1):
        super().__init__()
        w, vr = width_multiplier, voxel_resolution_multiplier
        li, cin, concat = 0, in_channels, 0
        for out_ch, num_blocks, res in BLOCKS:
            oc = int(w * out_ch)
            for _ in range(num_blocks):
                if res is None:
                    block = SharedMLP(cin, (oc,))
                else:
                    block = PVConv(cin, oc, int(vr * res))
                self.add_module(f"pf{li}", block)
                cin, concat, li = oc, concat + oc, li + 1
        self.blocks = li
        c0, c1 = int(w * 256), int(w * 128)
        self.cloud0 = nn.Linear(cin, c0)
        self.cloud_bn0 = BatchNorm(c0, eps=1e-5, momentum=BN_MOMENTUM)
        self.cloud1 = nn.Linear(c0, c1)
        self.cloud_bn1 = BatchNorm(c1, eps=1e-5, momentum=BN_MOMENTUM)
        self.cls0 = SharedMLP(concat + c1, (int(w * 512),))
        self.cls1 = SharedMLP(int(w * 512), (int(w * 256),))
        self.cls2 = nn.Linear(int(w * 256), num_classes)
        self.dropout = Dropout(0.3)

    def forward(self, inputs):
        coords, feat = inputs["point"], inputs["feat"]
        outs = []
        for i in range(self.blocks):
            block = getattr(self, f"pf{i}")
            feat = (block(feat, coords) if isinstance(block, PVConv) else
                    block(feat))
            outs.append(feat)
        cloud = F.relu(self.cloud_bn0(self.cloud0(cloud_max(feat))))
        cloud = F.relu(self.cloud_bn1(self.cloud1(cloud)))
        outs.append(cloud[:, None, :].expand(-1, feat.shape[1], -1))
        x = self.dropout(self.cls0(torch.cat(outs, dim=-1)))
        x = self.dropout(self.cls1(x))
        return self.cls2(x)


@MODEL.register_module()
class PVCNN(BaseModel):
    """PVCNN model: configuration, the network and the host side
    (``preprocess``, ``transform``, ``get_loss``, ``get_optimizer``,
    ``update_probs``).

    The defaults are the JAX class's; ``pvcnn_s3dis.yml`` sets
    ``voxel_resolution_multiplier`` 2 (grids of 64^3 and 32^3) and
    ``ignored_label_inds`` [-1].
    """

    # ``transform`` returns ``preprocess``'s random draw of points and never
    # advances the sampler's possibility map, so the pipeline's test and
    # inference loop would never end (in the JAX package too)
    draws_patches = False
    patch_loop_queue = "ROADMAP queue 1 item 10, PVCNN"

    def __init__(self,
                 name="PVCNN",
                 num_classes=13,
                 num_points=40960,
                 extra_feature_channels=6,
                 width_multiplier=1,
                 voxel_resolution_multiplier=1,
                 ignored_label_inds=[],
                 batcher="DefaultBatcher",
                 augment=None,
                 **kwargs):
        super().__init__(
            name=name, num_classes=num_classes, num_points=num_points,
            extra_feature_channels=extra_feature_channels,
            width_multiplier=width_multiplier,
            voxel_resolution_multiplier=voxel_resolution_multiplier,
            ignored_label_inds=ignored_label_inds, batcher=batcher,
            augment=augment, **kwargs)
        self.augmenter = SemsegAugmentation(self.cfg.augment, seed=self.rng)
        self.in_channels = extra_feature_channels + 3

    def get_net(self):
        cfg = self.cfg
        return PVCNNNet(
            num_classes=cfg.num_classes, in_channels=self.in_channels,
            width_multiplier=cfg.width_multiplier,
            voxel_resolution_multiplier=cfg.voxel_resolution_multiplier)

    def preprocess(self, data, attr, rng=None):
        """Augment (the training split only), move the cloud's minimum to
        0, build the 9 features (the points, the colours / 255, the points
        over their per-axis maximum) and draw ``num_points`` of them (with
        replacement where the cloud has fewer). Every draw comes from
        ``rng`` (the model's by default), in the JAX package's order."""
        cfg = self.cfg
        rng = rng or self.rng
        points = np.array(data["point"], dtype=np.float32)
        labels = (np.zeros((points.shape[0],), np.int32)
                  if data.get("label") is None else
                  np.array(data["label"], np.int32).reshape(-1))
        feat = (points.copy() if data.get("feat") is None else
                np.array(data["feat"], np.float32))

        if attr["split"] in ("training", "train"):
            points, feat, labels = self.augmenter.augment(
                points, feat, labels, dict(cfg.get("augment") or {}),
                seed=rng)

        points -= np.min(points, 0)
        feat = feat / 255.0
        mx = np.maximum(np.max(points, 0), 1e-6)
        norm = points / mx
        feat = np.concatenate([points, feat, norm], axis=-1)

        choices = rng.choice(points.shape[0], cfg.num_points,
                             replace=(points.shape[0] < cfg.num_points))
        return {
            "point": points[choices].astype(np.float32),
            "feat": feat[choices].astype(np.float32),
            "label": labels[choices].astype(np.int32),
            "point_inds": choices.astype(np.int32),
        }

    def transform(self, data, attr):
        return data

    def get_loss(self, loss, results, inputs):
        """(loss, remapped labels [B * N], scores [B * N, num_classes]) of
        logits ``results`` [B, N, num_classes] against the raw labels
        ``inputs["label"]`` [B, N]; ``loss`` is a ``SemSegLoss``."""
        cfg = self.cfg
        labels = inputs["label"].reshape(-1)
        scores = results.reshape(-1, cfg.num_classes)
        remapped, valid = filter_valid_label(scores, labels, cfg.num_classes,
                                             cfg.ignored_label_inds)
        return (loss.weighted_cross_entropy(scores, remapped, valid),
                remapped, scores)

    def get_optimizer(self, cfg_pipeline, net):
        """(Adam over ``net``'s parameters, its learning-rate scheduler), as
        the JAX package's ``optax.adam``: the rate ``optimizer.lr`` (else
        ``adam_lr``, else 1e-2), betas (0.9, 0.999) and eps 1e-8 whatever
        the YAML's ``optimizer.betas`` say, and no weight decay (the JAX
        package reads neither ``optimizer.weight_decay`` nor ``betas``),
        decayed by ``scheduler_gamma`` once per ``steps_per_epoch``
        updates (``run_train`` sets it, else 1). Step the scheduler after
        every optimizer step."""
        opt = dict(cfg_pipeline.get("optimizer") or {})
        lr = opt.get("lr", cfg_pipeline.get("adam_lr", 1e-2))
        optimizer = torch.optim.Adam(net.parameters(), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        return optimizer, exponential_lr(
            optimizer, cfg_pipeline.get("scheduler_gamma", 1.0),
            steps_per_epoch=cfg_pipeline.get("steps_per_epoch", 1))

    def update_probs(self, inputs, results, test_probs):
        """Write each sample's class probabilities (softmax of its logits)
        into the cloud's ``test_probs`` [N, num_classes] at its points."""
        results = np.asarray(results)
        for b in range(results.shape[0]):
            logits = torch.from_numpy(np.ascontiguousarray(
                results[b].reshape(-1, self.cfg.num_classes)))
            inds = np.asarray(inputs["point_inds"][b])
            test_probs[inds] = torch.softmax(logits, dim=-1).numpy()
        return test_probs
