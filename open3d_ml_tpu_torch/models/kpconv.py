"""KPConv (KPFCNN) for semantic segmentation.

Counterpart of ``open3d_ml_tpu/models/kpconv.py``: kernel-point
convolutions, rigid or deformable, over a radius-neighbour pyramid that
``transform`` builds on the host, with the architecture list driving the
encoder and decoder blocks.

* The host side (``preprocess``, ``transform``) is the JAX model's, step
  for step: a ball patch of ``in_radius`` from the sampler, recentred, the
  augmentation on training splits, the features by ``in_features_dim``,
  and per level the points padded to the level's cap with rows at 1e6,
  the radius neighbours (the port's own KD-tree, ``native/``, the same
  C++ as the JAX package's: where a query has more neighbours than the
  limit, the order the tree visits them decides which are kept, so no
  other search may stand in for it), grid subsampling at twice the
  level's cell, the pool and upsample indices, and the sentinel remaps.
* ``KPConvOp`` is one gather of [coordinates, features] with a shadow
  row (coordinates 1e6, features 0) for the sentinel index, the kernel
  points' influences, and two contractions (``matmul``); as in the JAX
  package no kernel of its own runs here.
* The net takes the whole [B, ...] batch with batched gathers. Each
  BatchNorm (``models/common.py``, flax's semantics) reduces over every
  row of every sample, the cap's padded rows included, as the JAX net's
  BatchNorm does under ``nn.vmap`` over the batch axis; its torch
  momentum is the YAML's ``batch_norm_momentum`` (flax's is 1 minus it).

Module names follow the JAX scopes (``enc{i}``, ``dec{i}``, ``head_mlp``,
``head_softmax``, ``KPConv``, ``unary1``, ``unary2``, ``unary_shortcut``,
``offset_conv``), so ``utils/convert_jax.py`` maps one onto the other; the
kernel points are a buffer (``points``), the JAX ``kp_points`` collection.
"""

import functools

import numpy as np
import torch
from scipy.spatial import cKDTree
from torch import nn

from ..datasets.augment import SemsegAugmentation
from ..datasets.utils import DataProcessing
from ..modules.losses import filter_valid_label
from ..modules.schedulers import exponential_lr
from ..native import NativeKDTree
from ..utils.registry import MODEL
from .base_model import BaseModel
from .common import BatchNorm

SHADOW = 1e6  # coordinate of the padded points and of the shadow row


@functools.lru_cache(maxsize=64)
def kernel_point_lloyd(radius, num_points, dimension=3, fixed="center",
                       num_iter=60, seed=42):
    """Kernel point positions [num_points, dimension] float32: Lloyd
    iterations over uniform samples of the unit ball (the centre pinned
    for ``fixed`` "center", and two vertical points too for
    "verticals"), scaled so the farthest lies at 0.66 ``radius``. The JAX
    package's numpy steps in the same order, so the same bits."""
    rng = np.random.default_rng(seed)
    n_samples = 20000
    samples = rng.uniform(-1, 1, (n_samples * 3, dimension))
    samples = samples[np.linalg.norm(samples, axis=1) <= 1][:n_samples]

    centers = rng.uniform(-1, 1, (num_points * 10, dimension))
    centers = centers[np.linalg.norm(centers, axis=1) <= 1][:num_points]
    if fixed in ("center", "verticals"):
        centers[0] = 0.0
    if fixed == "verticals" and dimension == 3 and num_points >= 3:
        centers[1] = [0, 0, 0.5]
        centers[2] = [0, 0, -0.5]

    for _ in range(num_iter):
        d2 = ((samples[:, None, :] - centers[None, :, :])**2).sum(-1)
        assign = d2.argmin(1)
        for c in range(num_points):
            pts = samples[assign == c]
            if len(pts):
                centers[c] = pts.mean(0)
        if fixed in ("center", "verticals"):
            centers[0] = 0.0
        if fixed == "verticals" and dimension == 3 and num_points >= 3:
            centers[1, :2] = 0.0
            centers[2, :2] = 0.0

    scale = np.linalg.norm(centers, axis=1).max()
    if scale > 0:
        centers = centers / scale * 0.66
    return (centers * radius).astype(np.float32)


def leaky_relu(x, slope):
    """jax.nn.leaky_relu: the slope below 0 only (the gradient at 0 is 1)."""
    return torch.where(x >= 0, x, x * slope)


def gather_rows(values, idx):
    """values [B, N, C], idx [B, ...] -> [B, ..., C]: one ``index_select``
    over the flattened rows, whose backward is ``index_add_``. (The
    backward of advanced indexing, ``values[rows, idx]``, sorts the
    indices and took 453 of a step's 462 device ms on the H100, the
    sentinel row repeated in every padded and short neighbour list.)"""
    b, n, c = values.shape
    offsets = torch.arange(b, device=idx.device) * n
    flat = idx.long() + offsets.view(b, *([1] * (idx.dim() - 1)))
    return values.reshape(b * n, c).index_select(
        0, flat.reshape(-1)).reshape(*idx.shape, c)


def _with_zero_row(x):
    return torch.cat([x, x.new_zeros(x.shape[0], 1, x.shape[-1])], 1)


def max_pool(x, inds):
    """x [B, N, C], inds [B, Q, K] (sentinel N: a zero row) -> the max over
    the K gathered rows [B, Q, C]. A tie shares the gradient evenly, as
    JAX's max does; a missing neighbour is a 0, so the max over negative
    features with one is 0."""
    return gather_rows(_with_zero_row(x), inds).amax(dim=2)


def closest_pool(x, inds):
    """The rows of the first (closest) neighbour: x [B, N, C], inds [B, Q,
    K] (sentinel N: a zero row) -> [B, Q, C]."""
    return gather_rows(_with_zero_row(x), inds[..., 0])


class KPConvOp(nn.Module):
    """One kernel-point convolution: q_pts [B, Nq, 3], s_pts [B, Ns, 3],
    neighb_inds [B, Nq, K] (sentinel Ns), x [B, Ns, Cin] -> [B, Nq,
    Cout].

    ``weights`` [P, Cin, Cout]; ``points`` [P, 3], the kernel points (a
    buffer: ``kernel_point_lloyd``'s unless loaded). A deformable
    convolution shifts its kernel points per query by a rigid
    ``offset_conv`` (3P outputs) plus ``offset_bias``, in units of
    ``kp_extent``, and in train mode keeps its two point-to-point
    regularizer terms, each per sample ([B]), in ``p2p``."""

    def __init__(self, num_kernel_points, in_channels, out_channels,
                 kp_extent, radius, fixed_kernel_points="center",
                 kp_influence="linear", aggregation_mode="sum",
                 deformable=False, repulse_extent=1.2):
        super().__init__()
        p = num_kernel_points
        self.num_kernel_points = p
        self.kp_extent = kp_extent
        self.kp_influence = kp_influence
        self.aggregation_mode = aggregation_mode
        self.deformable = deformable
        self.repulse_extent = repulse_extent
        self.weights = nn.Parameter(torch.empty(p, in_channels, out_channels))
        self.register_buffer("points", torch.from_numpy(kernel_point_lloyd(
            radius, p, fixed=fixed_kernel_points)))
        if deformable:
            self.offset_conv = KPConvOp(
                p, in_channels, 3 * p, kp_extent, radius,
                fixed_kernel_points, kp_influence, aggregation_mode)
            self.offset_bias = nn.Parameter(torch.zeros(3 * p))
        self.p2p = None
        self.reset_parameters()

    def reset_parameters(self, gen=None):
        """``weights`` as flax's variance_scaling(2, "fan_in", "uniform"):
        uniform in +-sqrt(6 / (P * Cin)); ``offset_bias`` 0. The offset
        convolution draws its own."""
        p, cin, _ = self.weights.shape
        bound = (6.0 / (p * cin)) ** 0.5
        with torch.no_grad():
            self.weights.uniform_(-bound, bound, generator=gen)
            if self.deformable:
                self.offset_bias.zero_()

    def _influence(self, sq_d):
        if self.kp_influence == "constant":
            return torch.ones_like(sq_d)
        if self.kp_influence == "linear":
            return torch.clamp(
                1 - torch.sqrt(sq_d + 1e-12) / self.kp_extent, min=0.0)
        if self.kp_influence == "gaussian":
            sigma = self.kp_extent * 0.3
            return torch.exp(-sq_d / (2 * sigma**2))
        raise ValueError(self.kp_influence)

    def forward(self, q_pts, s_pts, neighb_inds, x):
        p = self.num_kernel_points
        b, nq = q_pts.shape[:2]
        kp = self.points.to(s_pts.dtype)
        cat = torch.cat([s_pts, x.to(s_pts.dtype)], -1)
        shadow = torch.cat([s_pts.new_full((b, 1, 3), SHADOW),
                            s_pts.new_zeros(b, 1, x.shape[-1])], -1)
        gathered = gather_rows(torch.cat([cat, shadow], 1), neighb_inds)
        neighbors = gathered[..., :3] - q_pts[:, :, None, :]  # [B,Nq,K,3]

        if self.deformable:
            offset_feat = self.offset_conv(q_pts, s_pts, neighb_inds, x)
            offsets = (offset_feat + self.offset_bias).reshape(
                b, nq, p, 3) * self.kp_extent
            k_points = kp + offsets  # [B, Nq, P, 3]
            diff = neighbors[:, :, :, None, :] - k_points[:, :, None, :, :]
        else:
            diff = neighbors[:, :, :, None, :] - kp
        sq_d = torch.sum(diff * diff, -1)  # [B, Nq, K, P]

        if self.deformable and self.training:
            ext2 = self.kp_extent ** 2
            fitting = sq_d.amin(dim=2).mean(dim=(1, 2)) / ext2
            kp_locs = k_points / self.kp_extent
            other = kp_locs.detach()
            pd = torch.sqrt(torch.sum(
                (kp_locs[:, :, :, None, :] - other[:, :, None, :, :]) ** 2,
                -1) + 1e-12)  # [B, Nq, P, P]
            pair_mask = 1.0 - torch.eye(p, dtype=pd.dtype, device=pd.device)
            rep = torch.sum(torch.clamp(pd - self.repulse_extent, max=0.0)
                            ** 2 * pair_mask, -1)  # [B, Nq, P]
            self.p2p = {"fitting": fitting,
                        "repulsive": rep.sum(-1).mean(-1) / p}

        all_w = self._influence(sq_d)
        if self.aggregation_mode == "closest":
            closest = torch.argmin(sq_d, dim=3)
            all_w = all_w * nn.functional.one_hot(closest, p).to(all_w.dtype)

        neighb_x = gathered[..., 3:].to(x.dtype)  # [B, Nq, K, Cin]
        weighted = all_w.transpose(-1, -2) @ neighb_x  # [B, Nq, P, Cin]
        out = weighted.reshape(b * nq, -1) @ self.weights.reshape(
            -1, self.weights.shape[-1])
        return out.reshape(b, nq, -1)


def _norm(module, x, name, use_bn):
    """Apply ``_bn``'s layer ``name`` of ``module``."""
    layer = getattr(module, name)
    return layer(x) if use_bn else x + layer


def _add_norm(owner, prefix, dim, use_bn, momentum):
    """Register ``_bn``'s layer on ``owner``; returns its name."""
    if use_bn:
        name = f"{prefix}_bn"
        owner.add_module(name, BatchNorm(dim, eps=1e-5, momentum=momentum))
    else:
        name = f"{prefix}_bias"
        owner.register_parameter(name, nn.Parameter(torch.zeros(dim)))
    return name


class UnaryBlock(nn.Module):
    """Linear (no bias) -> BN (or a bias) -> LeakyReLU."""

    def __init__(self, in_dim, out_dim, use_bn=True, bn_momentum=0.02,
                 no_relu=False, l_relu=0.1):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)
        self.use_bn = use_bn
        self.norm = _add_norm(self, "unary", out_dim, use_bn, bn_momentum)
        self.no_relu = no_relu
        self.l_relu = l_relu

    def forward(self, x):
        x = _norm(self, self.mlp(x), self.norm, self.use_bn)
        return x if self.no_relu else leaky_relu(x, self.l_relu)


def _conv_inputs(block_name, layer_ind, batch):
    """(queries, support, neighbour indices) of a block at ``layer_ind``:
    a strided block's queries are the next level's points and its
    neighbours the pools."""
    if "strided" in block_name:
        return (batch["points"][layer_ind + 1], batch["points"][layer_ind],
                batch["pools"][layer_ind])
    return (batch["points"][layer_ind], batch["points"][layer_ind],
            batch["neighbors"][layer_ind])


def _kpconv(cfg, block_name, in_channels, out_channels, radius):
    extent = radius * cfg["KP_extent"] / cfg["conv_radius"]
    return KPConvOp(cfg["num_kernel_points"], in_channels, out_channels,
                    extent, radius, cfg["fixed_kernel_points"],
                    cfg["KP_influence"], cfg["aggregation_mode"],
                    deformable="deform" in block_name,
                    repulse_extent=cfg.get("repulse_extent", 1.2))


class SimpleBlock(nn.Module):
    """KPConv (to ``out_dim // 2``) -> BN -> LeakyReLU."""

    def __init__(self, block_name, in_width, out_dim, radius, layer_ind,
                 cfg):
        super().__init__()
        self.block_name, self.layer_ind = block_name, layer_ind
        self.use_bn, self.l_relu = cfg["use_batch_norm"], cfg["l_relu"]
        self.KPConv = _kpconv(cfg, block_name, in_width, out_dim // 2,
                              radius)
        self.norm = _add_norm(self, "simple", out_dim // 2, self.use_bn,
                              cfg["batch_norm_momentum"])

    def forward(self, x, batch):
        x = self.KPConv(*_conv_inputs(self.block_name, self.layer_ind,
                                      batch), x)
        return leaky_relu(_norm(self, x, self.norm, self.use_bn),
                          self.l_relu)


class ResnetBottleneckBlock(nn.Module):
    """unary1 (where ``in_dim != out_dim // 4``) -> KPConv -> BN ->
    LeakyReLU -> unary2 (no ReLU), plus the shortcut (max-pooled on a
    strided block; unary_shortcut where ``in_dim != out_dim``), ->
    LeakyReLU. ``in_dim`` is the JAX net's count, which decides the
    layers; ``in_width`` the input's width, which sizes them."""

    def __init__(self, block_name, in_dim, in_width, out_dim, radius,
                 layer_ind, cfg):
        super().__init__()
        self.block_name, self.layer_ind = block_name, layer_ind
        use_bn, mom = cfg["use_batch_norm"], cfg["batch_norm_momentum"]
        self.use_bn, self.l_relu = use_bn, cfg["l_relu"]
        lr = self.l_relu
        if in_dim != out_dim // 4:
            self.unary1 = UnaryBlock(in_width, out_dim // 4, use_bn, mom,
                                     l_relu=lr)
        self.KPConv = _kpconv(cfg, block_name, out_dim // 4, out_dim // 4,
                              radius)
        self.norm = _add_norm(self, "conv", out_dim // 4, use_bn, mom)
        self.unary2 = UnaryBlock(out_dim // 4, out_dim, use_bn, mom,
                                 no_relu=True, l_relu=lr)
        if in_dim != out_dim:
            self.unary_shortcut = UnaryBlock(in_width, out_dim, use_bn, mom,
                                             no_relu=True, l_relu=lr)

    def forward(self, x, batch):
        q, s, nb = _conv_inputs(self.block_name, self.layer_ind, batch)
        feat = self.unary1(x) if hasattr(self, "unary1") else x
        feat = self.KPConv(q, s, nb, feat)
        feat = leaky_relu(_norm(self, feat, self.norm, self.use_bn),
                          self.l_relu)
        feat = self.unary2(feat)
        shortcut = max_pool(x, nb) if "strided" in self.block_name else x
        if hasattr(self, "unary_shortcut"):
            shortcut = self.unary_shortcut(shortcut)
        return leaky_relu(feat + shortcut, self.l_relu)


class _MaxPool(nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x, batch):
        return max_pool(x, batch["pools"][self.layer])


class _Upsample(nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x, batch):
        return closest_pool(x, batch["upsamples"][self.layer])


class KPFCNNNet(nn.Module):
    """The network: ``forward(batch)`` with ``features`` [B, N0, in_width],
    and per level ``points`` [B, cap_l, 3], ``neighbors`` [B, cap_l, K_l],
    ``pools`` [B, cap_{l+1}, K_l] and ``upsamples`` [B, cap_l, 1] ->
    logits [B, N0, num_classes]. ``cfg``: the model's configuration keys
    the JAX ``get_net`` passes; ``in_width``: the features' width."""

    def __init__(self, cfg, num_classes, in_width):
        super().__init__()
        arch = list(cfg["architecture"])
        use_bn, mom, lr = (cfg["use_batch_norm"], cfg["batch_norm_momentum"],
                           cfg["l_relu"])
        self.in_width = in_width
        layer = 0
        r = cfg["first_subsampling_dl"] * cfg["conv_radius"]
        in_dim, width = cfg["in_features_dim"], in_width
        out_dim = cfg["first_features_dim"]

        # the blocks in order, each (name, kind): kind "skip" marks where a
        # skip is kept before the block; "cat" where one is concatenated
        self.plan = []
        skip_widths = []
        block_i = 0
        for block in arch:
            if "upsample" in block:
                break
            if any(t in block for t in ("pool", "strided", "global")):
                self.plan.append((None, "skip"))
                skip_widths.append(width)
            name = f"enc{block_i}"
            if "simple" in block:
                self.add_module(name, SimpleBlock(block, width, out_dim, r,
                                                  layer, cfg))
                in_dim = width = out_dim // 2
            elif "resnetb" in block:
                self.add_module(name, ResnetBottleneckBlock(
                    block, in_dim, width, out_dim, r, layer, cfg))
                in_dim = width = out_dim
            elif block == "unary":
                self.add_module(name, UnaryBlock(width, out_dim, use_bn, mom,
                                                 l_relu=lr))
                in_dim = width = out_dim
            elif "max_pool" in block or "pool" == block:
                self.add_module(name, _MaxPool(layer))
            else:
                raise ValueError(f"Unknown encoder block {block}")
            self.plan.append((name, "block"))
            if "pool" in block or "strided" in block:
                layer += 1
                r *= 2
                out_dim *= 2
            block_i += 1

        decoder = arch[block_i:]
        for bi, block in enumerate(decoder):
            if bi > 0 and "upsample" in decoder[bi - 1]:
                self.plan.append((None, "cat"))
                width += skip_widths.pop()
            name = f"dec{bi}"
            if block == "unary":
                self.add_module(name, UnaryBlock(width, out_dim, use_bn, mom,
                                                 l_relu=lr))
                width = out_dim
            elif "upsample" in block:
                self.add_module(name, _Upsample(layer - 1))
            else:
                raise ValueError(f"Unknown decoder block {block}")
            self.plan.append((name, "block"))
            if "upsample" in block:
                layer -= 1
                out_dim = out_dim // 2
            if bi == 0 and cfg.get("reduce_fc"):
                out_dim = out_dim // 2

        first = cfg["first_features_dim"]
        if cfg.get("reduce_fc"):
            self.head_mlp = UnaryBlock(width, first // 2, use_bn, mom,
                                       l_relu=lr)
            width = first // 2
        else:
            self.head_mlp = UnaryBlock(width, first, False, 0, l_relu=lr)
            width = first
        self.head_softmax = UnaryBlock(width, num_classes, False, 0,
                                       no_relu=True, l_relu=lr)

    def forward(self, batch):
        x = batch["features"]
        if x.shape[-1] != self.in_width:
            raise ValueError(
                f"features of width {x.shape[-1]}; the net was built for "
                f"{self.in_width} (KPFCNN.input_width)")
        skips = []
        for name, kind in self.plan:
            if kind == "skip":
                skips.append(x)
            elif kind == "cat":
                x = torch.cat([x, skips.pop()], -1)
            elif isinstance(getattr(self, name), UnaryBlock):
                x = getattr(self, name)(x)
            else:
                x = getattr(self, name)(x, batch)
        return self.head_softmax(self.head_mlp(x))


@MODEL.register_module()
class KPFCNN(BaseModel):
    """KPFCNN: configuration, the network and the host side
    (``preprocess``, ``transform``, ``get_loss``, ``regularizer_loss``,
    ``get_optimizer``, ``update_probs``).

    The defaults are the JAX class's (the SemanticKITTI YAML's model
    section). With ``in_features_dim`` above 2 the features are [1, feat]
    (or [1, x, y, z] without feat) cut to ``in_features_dim`` columns, so
    with the 3 colour columns the readers give, the S3DIS, Semantic3D and
    Toronto3D YAMLs' 5 give 4 columns; the JAX net sizes its first
    convolution from its input, and the port's is built for the width
    ``transform`` emits (``input_width``) and raises on another.
    """

    def __init__(self,
                 name="KPFCNN",
                 lbl_values=list(range(20)),
                 num_classes=19,
                 ignored_label_inds=[0],
                 architecture=[
                     "simple", "resnetb", "resnetb_strided", "resnetb",
                     "resnetb", "resnetb_strided", "resnetb", "resnetb",
                     "resnetb_strided", "resnetb", "resnetb",
                     "resnetb_strided", "resnetb", "nearest_upsample",
                     "unary", "nearest_upsample", "unary",
                     "nearest_upsample", "unary", "nearest_upsample", "unary"
                 ],
                 in_radius=4.0,
                 max_in_points=100000,
                 num_points=16384,
                 num_kernel_points=15,
                 first_subsampling_dl=0.06,
                 conv_radius=2.5,
                 deform_radius=6.0,
                 deform_fitting_mode="point2point",
                 deform_fitting_power=1.0,
                 repulse_extent=1.2,
                 KP_extent=1.2,
                 KP_influence="linear",
                 aggregation_mode="sum",
                 first_features_dim=128,
                 in_features_dim=2,
                 modulated=False,
                 use_batch_norm=True,
                 batch_norm_momentum=0.02,
                 fixed_kernel_points="center",
                 num_layers=5,
                 l_relu=0.1,
                 neighborhood_limits=[16, 21, 27, 33, 37],
                 reduce_fc=False,
                 pyramid_ratio=3,
                 batcher="DefaultBatcher",
                 augment=None,
                 t_normalize=None,
                 ckpt_path=None,
                 **kwargs):
        super().__init__(
            name=name, lbl_values=lbl_values, num_classes=num_classes,
            ignored_label_inds=ignored_label_inds,
            architecture=architecture, in_radius=in_radius,
            max_in_points=max_in_points, num_points=num_points,
            num_kernel_points=num_kernel_points,
            first_subsampling_dl=first_subsampling_dl,
            conv_radius=conv_radius, deform_radius=deform_radius,
            deform_fitting_mode=deform_fitting_mode,
            deform_fitting_power=deform_fitting_power,
            repulse_extent=repulse_extent,
            KP_extent=KP_extent, KP_influence=KP_influence,
            aggregation_mode=aggregation_mode,
            first_features_dim=first_features_dim,
            in_features_dim=in_features_dim, modulated=modulated,
            use_batch_norm=use_batch_norm,
            batch_norm_momentum=batch_norm_momentum,
            fixed_kernel_points=fixed_kernel_points, num_layers=num_layers,
            l_relu=l_relu, neighborhood_limits=neighborhood_limits,
            reduce_fc=reduce_fc,
            pyramid_ratio=pyramid_ratio, batcher=batcher, augment=augment,
            t_normalize=t_normalize, ckpt_path=ckpt_path, **kwargs)
        self.augmenter = SemsegAugmentation(self.cfg.augment, seed=self.rng)

    def _num_layers(self):
        """Pyramid levels: 1 + the strided and pool blocks."""
        return 1 + sum("strided" in b or ("pool" in b)
                       for b in self.cfg.architecture)

    def _pyramid_caps(self):
        """Each level's point cap: num_points / pyramid_ratio^l, at least
        64."""
        cfg = self.cfg
        caps = []
        n = cfg.num_points
        for _ in range(self._num_layers()):
            caps.append(max(int(n), 64))
            n = n / cfg.pyramid_ratio
        return caps

    def input_width(self):
        """The width of the features ``transform`` emits from a cloud of 3
        feature columns, or of none: ``in_features_dim``, at most 4."""
        return min(self.cfg.in_features_dim, 4)

    def get_net(self):
        """The network (``KPFCNNNet``)."""
        cfg = self.cfg
        net_cfg = {key: cfg[key] for key in (
            "architecture", "num_kernel_points", "first_subsampling_dl",
            "conv_radius", "KP_extent", "KP_influence", "aggregation_mode",
            "first_features_dim", "in_features_dim", "use_batch_norm",
            "batch_norm_momentum", "fixed_kernel_points", "l_relu")}
        net_cfg["reduce_fc"] = bool(cfg.get("reduce_fc", False))
        # like the JAX get_net, no repulse_extent: every deformable
        # convolution repulses at 1.2 whatever the configuration says
        return KPFCNNNet(net_cfg, cfg.num_classes, self.input_width())

    # ------------------------------------------------------------- host side

    def preprocess(self, data, attr):
        """Grid-subsample at ``first_subsampling_dl``, build the KD-tree,
        and for a test split each input point's nearest kept point
        (``proj_inds``)."""
        cfg = self.cfg
        points = np.array(data["point"][:, 0:3], dtype=np.float32)
        labels = (np.zeros((points.shape[0],), np.int32)
                  if data.get("label") is None else
                  np.array(data["label"], np.int32).reshape(-1))
        feat = (None if data.get("feat") is None else
                np.array(data["feat"], np.float32))
        if feat is None:
            sub_points, sub_labels = DataProcessing.grid_subsampling(
                points, labels=labels, grid_size=cfg.first_subsampling_dl)
            sub_feat = None
        else:
            sub_points, sub_feat, sub_labels = \
                DataProcessing.grid_subsampling(
                    points, features=feat, labels=labels,
                    grid_size=cfg.first_subsampling_dl)
        search_tree = cKDTree(sub_points)
        out = {"point": sub_points, "feat": sub_feat, "label": sub_labels,
               "search_tree": search_tree}
        if attr["split"] in ("test", "testing"):
            _, proj = search_tree.query(points, k=1)
            out["proj_inds"] = np.asarray(proj, np.int32).reshape(-1)
        return out

    def transform(self, data, attr, rng=None):
        """A ball patch of ``in_radius`` from the sampler, recentred,
        augmented on a training split, and its pyramid: per level the
        points padded to the cap with rows at 1e6, their radius
        neighbours (sentinel: the cap), and towards the next level (the
        points grid-subsampled at twice the cell) the pools and the
        upsamples (the nearest point within the cell, else the nearest
        of all). Features, labels and ``point_inds`` are cut or padded to
        cap 0 (padding: ``point_inds`` -1, ``point_mask`` False). Every
        draw comes from ``rng`` (the model's by default), in the JAX
        package's order."""
        cfg = self.cfg
        rng = rng or self.rng

        pc = data["point"].copy()
        labels = data["label"].copy()
        feat = data["feat"].copy() if data["feat"] is not None else None
        tree = data["search_tree"]

        pts, sel, center = self.trans_point_sampler(
            pc=pc, feat=feat, label=labels, search_tree=tree,
            num_points=cfg.num_points, radius=cfg.in_radius, rng=rng)
        sel = np.asarray(sel)
        labels = labels[sel]
        if feat is not None:
            feat = feat[sel]
        pts = pts - np.asarray(center).reshape(1, -1)

        if attr["split"] in ("training", "train"):
            pts, feat, labels = self.augmenter.augment(
                pts, feat, labels, dict(cfg.get("augment") or {}), seed=rng)

        n = pts.shape[0]
        ones = np.ones((n, 1), np.float32)
        if cfg.in_features_dim == 1:
            features = ones
        elif cfg.in_features_dim == 2:
            features = np.concatenate([ones, pts[:, 2:3]], axis=1)
        elif feat is not None:
            features = np.concatenate([ones, feat],
                                      axis=1)[:, :cfg.in_features_dim]
        else:
            features = np.concatenate([ones, pts],
                                      axis=1)[:, :cfg.in_features_dim]

        caps = self._pyramid_caps()
        limits = list(cfg.neighborhood_limits)
        while len(limits) < len(caps):
            limits.append(limits[-1])

        def pad_points(p, cap):
            out = np.full((cap, 3), SHADOW, np.float32)
            k = min(len(p), cap)
            out[:k] = p[:k]
            return out, k

        points_pyr, neighbors_pyr, pools_pyr, upsamples_pyr = [], [], [], []
        cur = pts
        dl = cfg.first_subsampling_dl
        r = dl * cfg.conv_radius
        cur_pad, k = pad_points(cur, caps[0])
        # one tree a level: the level's neighbours and pools, and the
        # upsamples of the level above, all search its first k points
        cur_tree = NativeKDTree(cur_pad[:k])
        for lyr in range(len(caps)):
            points_pyr.append(cur_pad)
            nb, _ = cur_tree.query_radius_padded(cur_pad, r, limits[lyr],
                                                 fill=k)
            nb[nb == k] = caps[lyr]
            nb = np.where(nb >= k, caps[lyr], nb)
            neighbors_pyr.append(nb.astype(np.int32))
            if lyr == len(caps) - 1:
                break
            sub = DataProcessing.grid_subsampling(cur[:k].astype(np.float32),
                                                  grid_size=dl * 2)
            sub_pad, ks = pad_points(sub, caps[lyr + 1])
            pool, _ = cur_tree.query_radius_padded(sub_pad, r, limits[lyr],
                                                   fill=k)
            pool = np.where(pool >= k, caps[lyr], pool)
            pools_pyr.append(pool.astype(np.int32))
            sub_tree = NativeKDTree(sub_pad[:ks])
            up, _ = sub_tree.query_radius_padded(cur_pad, dl * 2, 1, fill=ks)
            miss = up[:, 0] >= ks
            if miss.any():
                _, nn1 = cKDTree(sub).query(cur_pad[miss][:, :3], k=1)
                up[miss, 0] = nn1
            up = np.where(up >= ks, caps[lyr + 1], up)
            upsamples_pyr.append(up.astype(np.int32))
            cur, cur_pad, k, cur_tree = sub, sub_pad, ks, sub_tree
            dl *= 2
            r *= 2

        cap0 = caps[0]
        n_in = min(features.shape[0], cap0)
        pad_n = cap0 - n_in
        features = features[:cap0].astype(np.float32)
        return {
            "features": np.concatenate(
                [features, np.zeros((pad_n, features.shape[1]),
                                    np.float32)]),
            "labels": np.concatenate([labels[:cap0].astype(np.int32),
                                      np.zeros((pad_n,), np.int32)]),
            "point_inds": np.concatenate([sel[:cap0].astype(np.int32),
                                          np.full((pad_n,), -1, np.int32)]),
            "point_mask": np.arange(cap0) < n_in,
            "points": points_pyr,
            "neighbors": neighbors_pyr,
            "pools": pools_pyr,
            "upsamples": upsamples_pyr,
        }

    # ----------------------------------------------------------- device side

    def get_loss(self, loss, results, inputs):
        """(loss, remapped labels [B * N], scores [B * N, num_classes]) of
        logits ``results`` [B, N, num_classes] against the raw labels
        ``inputs["labels"]``, over the valid rows of ``point_mask``;
        ``loss`` is a ``SemSegLoss``."""
        cfg = self.cfg
        labels = inputs["labels"].reshape(-1)
        scores = results.reshape(-1, cfg.num_classes)
        remapped, valid = filter_valid_label(scores, labels, cfg.num_classes,
                                             cfg.ignored_label_inds)
        valid = valid & inputs["point_mask"].reshape(-1)
        return (loss.weighted_cross_entropy(scores, remapped, valid),
                remapped, scores)

    def regularizer_loss(self, net):
        """The deformable convolutions' point-to-point regularizer of
        ``net``'s last train-mode forward: power * (2 * fitting +
        repulsive), each term averaged over the batch and summed over the
        convolutions; 0 without deformable convolutions. A
        ``deform_fitting_mode`` other than point2point raises."""
        terms = [m.p2p for m in net.modules()
                 if isinstance(m, KPConvOp) and m.p2p is not None]
        if not terms:
            return 0.0
        mode = self.cfg.get("deform_fitting_mode", "point2point")
        if mode != "point2point":
            raise ValueError(f"fitting mode {mode!r} not implemented")
        fit = sum(t["fitting"].mean() for t in terms)
        rep = sum(t["repulsive"].mean() for t in terms)
        power = self.cfg.get("deform_fitting_power", 1.0)
        return power * (2.0 * fit + rep)

    def get_optimizer(self, cfg_pipeline, net):
        """(SGD over ``net``'s parameters, its scheduler), as the JAX
        package's ``optax.sgd``: the rate ``optimizer.lr`` (else 0.01),
        momentum ``optimizer.momentum`` (else 0.98), no dampening, under
        ``exponential_lr`` (``scheduler_gamma``, else 0.98477, per epoch
        of ``steps_per_epoch`` updates). Where the architecture holds a
        deformable block and ``deform_lr_factor`` is not 1, the parameters
        whose name holds ``offset`` form a second group at the rate times
        the factor (optax's ``multi_transform`` labels)."""
        opt = dict(cfg_pipeline.get("optimizer") or {})
        lr = opt.get("lr", 1e-2)
        gamma = cfg_pipeline.get("scheduler_gamma", 0.98477)
        steps = cfg_pipeline.get("steps_per_epoch", 1)
        momentum = opt.get("momentum", 0.98)
        factor = cfg_pipeline.get("deform_lr_factor", 1.0)
        named = list(net.named_parameters())
        if factor == 1.0 or "deform" not in "".join(self.cfg.architecture):
            groups = [{"params": [p for _, p in named]}]
        else:
            groups = [{"params": [p for k, p in named if "offset" not in k]},
                      {"params": [p for k, p in named if "offset" in k],
                       "lr": lr * factor}]
        optimizer = torch.optim.SGD(groups, lr=lr, momentum=momentum,
                                    dampening=0)
        return optimizer, exponential_lr(optimizer, gamma, steps)

    def update_probs(self, inputs, results, test_probs):
        """Blend each patch's class probabilities into the cloud's
        accumulator ``test_probs`` [N, num_classes] at its points (the
        rows of ``point_inds`` -1, padding, skipped), with weight 0.02 on
        the new ones."""
        test_smooth = 0.98
        results = np.asarray(results, np.float32)
        for b in range(results.shape[0]):
            logits = results[b].reshape(-1, self.cfg.num_classes)
            exp = np.exp(logits - logits.max(axis=-1, keepdims=True))
            probs = exp / exp.sum(axis=-1, keepdims=True)
            inds = np.asarray(inputs["point_inds"][b])
            valid = inds >= 0
            inds = inds[valid]
            test_probs[inds] = (test_smooth * test_probs[inds] +
                                (1 - test_smooth) * probs[valid])
        return test_probs
