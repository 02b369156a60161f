"""RandLA-Net for semantic segmentation: the fused bucket path and the exact
evaluation path.

Counterpart of ``open3d_ml_tpu/models/randlanet.py``: fc0 + BN, four
LocalFeatureAggregation encoder stages with 4x subsampling, a shared-MLP
bottleneck, four decoder stages with nearest-neighbour upsampling and skip
concatenation, and a 3-layer head, over a whole [B, N, C] batch. Two
neighbour paths share one ``state_dict``:

* ``knn_method="fused"`` (``get_net``): the batch runs in Hilbert-sorted
  order; every neighbour, pool and upsample read is a bucket gather
  (``ops/cuda/bucket.py``), and the logits come back in the caller's order.
* ``knn_method="exact"`` (``get_eval_net``): the exact k-NN pyramid
  (``ops/neighbors.py``, the ``knn_exact`` kernel) in the caller's order,
  whose first N // ratio points are each level's subsample; every read is
  an index gather.

With ``knn_on_device=False`` both nets read the pyramid that ``transform``
builds on the host (``coords_pyramid``, ``neighbor_indices``, ``sub_idx``,
``interp_idx``: the JAX package's keys, one array a level) instead of
searching, through the same index gathers as the exact path, in float32.

Layout is channels-last [..., C], as in the JAX package. The parameter
names follow the JAX variable tree (``utils/convert_jax.py`` maps one onto
the other). BatchNorm (``_BatchNorm``) has flax's training semantics and
torch's momentum 0.01 (flax 0.99) and eps 1e-6; dropout (``_Dropout``)
draws its mask from the net's own generator.

With ``compute_dtype="bfloat16"`` the fused path computes every Linear but
the last in bfloat16, BatchNorm and everything after it in float32, and its
gathers round the values they read to bfloat16, as the TPU kernel did. The
exact path computes in float32 whatever ``compute_dtype`` says, as the JAX
net does off the fused path.

The host side (``preprocess``, ``transform``, with the host pyramid where
``knn_on_device`` is False, ``update_probs``) prepares patches for
``pipelines/semantic_segmentation.py``; ``get_loss`` and
``get_optimizer`` are the training step's loss and its Adam.
"""

import functools
import logging

import numpy as np
import torch
import torch.nn.functional as F
from scipy.spatial import cKDTree
from torch import nn

from ..datasets.augment import SemsegAugmentation
from ..datasets.utils import DataProcessing
from ..modules.losses import filter_valid_label
from ..modules.schedulers import exponential_lr
from ..ops.bucket import build_bucket_pyramid, pad_seg
from ..ops.cuda.bucket import BucketGather
from ..ops.neighbors import build_knn_pyramid
from ..utils.registry import MODEL
from .base_model import BaseModel
from .common import BatchNorm
from .common import Dropout as _Dropout

log = logging.getLogger(__name__)

KNN_METHODS = ("fused", "exact")


def _dense(linear, x, dtype):
    """``linear`` applied in ``dtype`` (when None, float32, or float64 for
    a float64 input): inputs, weight and bias are all cast to it, as
    flax's Dense does."""
    dt = dtype or torch.promote_types(x.dtype, torch.float32)
    bias = None if linear.bias is None else linear.bias.to(dt)
    return F.linear(x.to(dt), linear.weight.to(dt), bias)


class _IndexLevel:
    """One pyramid level of a batch [B, N, .] in the caller's order: its
    neighbour, pool and upsample reads, each an index gather."""

    def __init__(self, coords, nbr_idx, pool_idx, up_idx):
        self.coords = coords
        self.nbr_idx = nbr_idx.long()
        self.pool_idx = pool_idx.long()
        self.up_idx = up_idx.long()
        self.batch = torch.arange(coords.shape[0],
                                  device=coords.device)[:, None]

    def gather(self, v):
        """[B, N, C] -> [B, N, K, C] neighbour rows."""
        return v[self.batch[..., None], self.nbr_idx]

    def pool_max(self, v):
        """[B, N, C] -> [B, N_sub, C]: max over each kept point's
        neighbours."""
        return v[self.batch[..., None], self.pool_idx].amax(dim=-2)

    def upsample(self, v):
        """[B, N_sub, C] -> [B, N, C]: each point takes its nearest sub
        point's row."""
        return v[self.batch, self.up_idx]


class _BucketLevel:
    """One pyramid level of a Hilbert-sorted batch [B, N, .]: its
    neighbour, pool and upsample reads, each a bucket gather."""

    def __init__(self, pyr, i, seg, round_bf16):
        self.coords = pyr["coords"][i]
        self.seg = seg
        self.round_bf16 = round_bf16
        self.tables = {name: (pyr[f"{name}_seg_ids"][i], pyr[f"{name}_rel"][i],
                              pyr[f"{name}_qblock"][i])
                       for name in ("nbr", "pool", "up")}

    def _gather(self, v, name):
        seg_ids, rel, qblock = self.tables[name]
        return BucketGather.apply(pad_seg(v, self.seg).contiguous(), seg_ids,
                                  rel, self.seg, qblock, self.round_bf16)

    def gather(self, v):
        """[B, N, C] -> [B, N, K, C] neighbour rows."""
        return self._gather(v, "nbr")

    def pool_max(self, v):
        """[B, N, C] -> [B, N_sub, C]: max over each kept point's
        neighbours."""
        return self._gather(v, "pool").amax(dim=-2)

    def upsample(self, v):
        """[B, N_sub, C] -> [B, N, C]: each point takes its nearest sub
        point's row."""
        return self._gather(v, "up")[..., 0, :]


# flax's BatchNorm over the last axis at RandLA-Net's eps
_BatchNorm = functools.partial(BatchNorm, eps=1e-6)


class SharedMLP(nn.Module):
    """Linear + BatchNorm + LeakyReLU over the channel axis."""

    def __init__(self, in_dim, out_dim, bn=True, slope=0.2, dtype=None):
        super().__init__()
        self.conv = nn.Linear(in_dim, out_dim)
        self.batch_norm = _BatchNorm(out_dim) if bn else None
        self.slope = slope
        self.dtype = dtype

    def forward(self, x):
        x = _dense(self.conv, x, self.dtype)
        if self.batch_norm is not None:
            # float32 parameters promote the (possibly bf16) product
            x = self.batch_norm(x)
        if self.slope is not None:
            x = F.leaky_relu(x, self.slope)
        return x


class LocalSpatialEncoding(nn.Module):
    """Relative-position encoding of the K neighbours, concatenated with
    their gathered features."""

    def __init__(self, in_dim, out_dim, encode_pos=False, dtype=None):
        super().__init__()
        self.encode_pos = encode_pos
        self.mlp = SharedMLP(in_dim, out_dim, dtype=dtype)

    def forward(self, coords, feat, level, relative_features=None):
        """coords [B, N, 3], feat [B, N, d] -> ([B, N, K, d + out_dim],
        the encoded relative features [B, N, K, out_dim])."""
        if self.encode_pos:
            # one gather of coords and features together
            gathered = level.gather(torch.cat([coords, feat], dim=-1))
            nbr_coords, nbr_feat = gathered[..., :3], gathered[..., 3:]
            ext_coords = coords[..., None, :]
            rel_pos = ext_coords - nbr_coords
            rel_dist = torch.sqrt(
                (rel_pos * rel_pos).sum(dim=-1, keepdim=True) + 1e-12)
            relative_features = torch.cat(
                [rel_dist, rel_pos, ext_coords.expand_as(nbr_coords),
                 nbr_coords], dim=-1)
        elif relative_features is None:
            raise ValueError("LSE second pass needs relative_features")
        else:
            nbr_feat = level.gather(feat)
        relative_features = self.mlp(relative_features)
        return (torch.cat([nbr_feat, relative_features], dim=-1),
                relative_features)


class AttentivePooling(nn.Module):
    """Attention-weighted sum over the K axis."""

    def __init__(self, in_dim, out_dim, dtype=None):
        super().__init__()
        self.score_fn = nn.Linear(in_dim, in_dim)
        self.mlp = SharedMLP(in_dim, out_dim, dtype=dtype)
        self.dtype = dtype

    def forward(self, x):
        """x [B, N, K, d_in] -> [B, N, d_out]."""
        scores = torch.softmax(_dense(self.score_fn, x, self.dtype), dim=-2)
        return self.mlp((scores * x).sum(dim=-2))


class LocalFeatureAggregation(nn.Module):
    """Dilated residual block: 2x (LSE -> AttentivePooling) + shortcut."""

    def __init__(self, d_in, d_out, dtype=None):
        super().__init__()
        d = d_out
        self.mlp1 = SharedMLP(d_in, d // 2, dtype=dtype)
        self.lse1 = LocalSpatialEncoding(10, d // 2, encode_pos=True,
                                         dtype=dtype)
        self.pool1 = AttentivePooling(d, d // 2, dtype=dtype)
        self.lse2 = LocalSpatialEncoding(d // 2, d // 2, dtype=dtype)
        self.pool2 = AttentivePooling(d, d, dtype=dtype)
        self.mlp2 = SharedMLP(d, 2 * d, slope=None, dtype=dtype)
        self.shortcut = SharedMLP(d_in, 2 * d, slope=None, dtype=dtype)

    def forward(self, coords, feat, level):
        """coords [B, N, 3], feat [B, N, d_in] -> [B, N, 2 * d_out]."""
        x = self.mlp1(feat)
        x, rel = self.lse1(coords, x, level)
        x = self.pool1(x)
        x, _ = self.lse2(coords, x, level, relative_features=rel)
        x = self.pool2(x)
        x = self.mlp2(x)
        return F.leaky_relu(x + self.shortcut(feat), 0.01)


class RandLANetNet(nn.Module):
    """The RandLA-Net network on the fused or the exact neighbour path.

    ``forward({"coords": [B, N, 3], "features": [B, N, in_channels]})``
    returns logits [B, N, num_classes] in the caller's point order. On the
    fused path, eval mode takes the inference table budget
    (``infer_num_segs``, ``infer_gather_segs``; 0 keeps the training
    budget); the exact path ignores the table knobs. With
    ``knn_on_device=False`` the inputs also hold the host-built pyramid
    (per level [B, N_i, 3] ``coords_pyramid``, [B, N_i, K]
    ``neighbor_indices``, [B, N_i / ratio, K] ``sub_idx``, [B, N_i, 1]
    ``interp_idx``), which the net reads in float32 whatever
    ``knn_method`` and ``compute_dtype`` say, as the JAX net does.
    """

    def __init__(self, num_neighbors, num_layers, num_classes, in_channels,
                 dim_features, dim_output, sub_sampling_ratio, seg, block,
                 num_segs, gather_segs, infer_num_segs, infer_gather_segs,
                 compute_dtype, knn_method="fused", knn_on_device=True):
        super().__init__()
        if compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        if knn_method not in KNN_METHODS:
            raise ValueError(f"knn_method {knn_method!r}")
        self.knn_method = knn_method
        self.knn_on_device = knn_on_device
        self.num_neighbors = num_neighbors
        self.num_layers = num_layers
        self.sub_sampling_ratio = list(sub_sampling_ratio)
        self.seg, self.block = seg, block
        self.num_segs, self.gather_segs = num_segs, gather_segs
        self.infer_num_segs = infer_num_segs
        self.infer_gather_segs = infer_gather_segs
        # bf16 on the fused path only, as in the JAX net
        self.round_bf16 = (knn_on_device and knn_method == "fused" and
                           compute_dtype == "bfloat16")
        cdt = torch.bfloat16 if self.round_bf16 else None
        self.cdt = cdt

        self.fc0 = nn.Linear(in_channels, dim_features)
        self.bn0 = _BatchNorm(dim_features)
        d_in = dim_features
        for i in range(num_layers):
            self.add_module(f"encoder_{i}", LocalFeatureAggregation(
                d_in, dim_output[i], dtype=cdt))
            d_in = 2 * dim_output[i]
        # channels of the skip features: level 0 before pooling, then each
        # level after it
        skips = [2 * dim_output[0]] + [2 * d
                                       for d in dim_output[:num_layers]]
        feat_dim = skips[-1]
        self.mlp = SharedMLP(feat_dim, feat_dim, dtype=cdt)
        for i in range(num_layers):
            skip = skips[-i - 2]
            self.add_module(f"decoder_{i}",
                            SharedMLP(skip + feat_dim, skip, dtype=cdt))
            feat_dim = skip
        self.fc1_0 = SharedMLP(feat_dim, 64, dtype=cdt)
        self.fc1_1 = SharedMLP(64, 32, dtype=cdt)
        # p = 0.5 in Hilbert-sorted order, as in the JAX net
        self.dropout = _Dropout(0.5)
        self.fc1_3 = SharedMLP(32, num_classes, bn=False, slope=None)

    def _levels(self, coords, inputs=None):
        """(levels, perm): per-level neighbour contexts, and the Hilbert
        permutation of the fused path (None on the other paths); with
        ``knn_on_device`` False, read from the host pyramid in
        ``inputs``."""
        if not self.knn_on_device:
            inputs = inputs or {}
            if "neighbor_indices" not in inputs:
                raise ValueError("RandLANet with knn_on_device=False reads "
                                 "the host-built pyramid from its inputs "
                                 "(RandLANet.transform builds it)")
            return [_IndexLevel(inputs["coords_pyramid"][i],
                                inputs["neighbor_indices"][i],
                                inputs["sub_idx"][i],
                                inputs["interp_idx"][i][..., 0])
                    for i in range(self.num_layers)], None
        if self.knn_method == "exact":
            pyr = build_knn_pyramid(coords, self.num_neighbors,
                                    self.sub_sampling_ratio)
            return [_IndexLevel(pyr["coords"][i],
                                pyr["neighbor_indices"][i],
                                pyr["sub_idx"][i],
                                pyr["interp_idx"][i][..., 0])
                    for i in range(self.num_layers)], None
        num_segs, gather_segs = self.num_segs, self.gather_segs
        if not self.training:
            num_segs = self.infer_num_segs or num_segs
            gather_segs = self.infer_gather_segs or gather_segs
        pyr = build_bucket_pyramid(
            coords, self.num_neighbors, self.sub_sampling_ratio, seg=self.seg,
            qblock=self.block, num_segs=num_segs, gather_segs=gather_segs)
        levels = [_BucketLevel(pyr, i, self.seg, self.round_bf16)
                  for i in range(self.num_layers)]
        return levels, pyr["perm"].long()

    def forward(self, inputs):
        levels, perm = self._levels(inputs["coords"], inputs)
        feat = inputs["features"]
        if perm is not None:
            # sorted order from here to the head
            feat = torch.gather(
                feat, 1, perm[..., None].expand(-1, -1, feat.shape[-1]))
        feat = self.bn0(_dense(self.fc0, feat, self.cdt))
        feat = F.leaky_relu(feat, 0.2)

        encoder_feats = []
        for i in range(self.num_layers):
            feat_enc = getattr(self, f"encoder_{i}")(levels[i].coords, feat,
                                                     levels[i])
            feat = levels[i].pool_max(feat_enc)
            if i == 0:
                encoder_feats.append(feat_enc)
            encoder_feats.append(feat)

        feat = self.mlp(feat)
        for i in range(self.num_layers):
            feat_interp = levels[-i - 1].upsample(feat)
            feat = getattr(self, f"decoder_{i}")(
                torch.cat([encoder_feats[-i - 2], feat_interp], dim=-1))

        feat = self.dropout(self.fc1_1(self.fc1_0(feat)))
        scores = self.fc1_3(feat)
        if perm is None:
            return scores
        # back to the caller's order: out[perm[i]] = scores[i]
        return torch.empty_like(scores).scatter_(
            1, perm[..., None].expand_as(scores), scores)


# knobs of the JAX model's fused path that the port has no path for, with
# the one value the port implements
_FUSED_ONLY = {"up_mode": "derive", "presorted": False, "gather_qblock": 0,
               "up_segs": 0}


@MODEL.register_module()
class RandLANet(BaseModel):
    """RandLA-Net model: configuration, the networks (``get_net``,
    ``get_eval_net``) and the host side of inference.

    The defaults are the model section of
    ``open3d_ml_tpu/configs/randlanet_semantickitti.yml``.
    """

    def __init__(self,
                 name="RandLANet",
                 batcher="DefaultBatcher",
                 ckpt_path=None,
                 num_neighbors=16,
                 num_layers=4,
                 num_points=45056,
                 num_classes=19,
                 ignored_label_inds=(0,),
                 sub_sampling_ratio=(4, 4, 4, 4),
                 in_channels=3,
                 dim_features=8,
                 dim_output=(16, 64, 128, 256),
                 grid_size=0.06,
                 knn_on_device=True,
                 knn_method="fused",
                 seg=64,
                 block=128,
                 num_segs=48,
                 gather_segs=24,
                 up_mode="derive",
                 infer_num_segs=32,
                 infer_gather_segs=16,
                 compute_dtype="bfloat16",
                 augment=None,
                 **kwargs):
        if augment is None:
            augment = {"recenter": {"dim": [0, 1]}}
        super().__init__(name=name, batcher=batcher, ckpt_path=ckpt_path,
                         num_neighbors=num_neighbors, num_layers=num_layers,
                         num_points=num_points, num_classes=num_classes,
                         ignored_label_inds=list(ignored_label_inds),
                         sub_sampling_ratio=list(sub_sampling_ratio),
                         in_channels=in_channels, dim_features=dim_features,
                         dim_output=list(dim_output), grid_size=grid_size,
                         knn_on_device=knn_on_device, knn_method=knn_method,
                         seg=seg, block=block, num_segs=num_segs,
                         gather_segs=gather_segs, up_mode=up_mode,
                         infer_num_segs=infer_num_segs,
                         infer_gather_segs=infer_gather_segs,
                         compute_dtype=compute_dtype, augment=augment,
                         **kwargs)
        self.augmenter = SemsegAugmentation(self.cfg.augment, seed=self.rng)

    def get_net(self, knn_method=None):
        """Build the network (``RandLANetNet``); ``knn_method`` overrides
        the configured neighbour path (both share one ``state_dict``)."""
        cfg = self.cfg
        method = knn_method or cfg.knn_method
        on_device = cfg.get("knn_on_device", True)
        ported = {"knn_method": (method, KNN_METHODS)}
        if method == "fused" and on_device:
            ported.update({key: (cfg.get(key, value), (value,))
                           for key, value in _FUSED_ONLY.items()})
        for key, (value, allowed) in ported.items():
            if value not in allowed:
                raise NotImplementedError(
                    f"RandLANet {key}={value!r} is not ported; the port "
                    f"runs {key} in {allowed}")
        return RandLANetNet(
            num_neighbors=cfg.num_neighbors,
            num_layers=cfg.num_layers,
            num_classes=cfg.num_classes,
            in_channels=cfg.in_channels,
            dim_features=cfg.dim_features,
            dim_output=list(cfg.dim_output),
            sub_sampling_ratio=list(cfg.sub_sampling_ratio),
            seg=cfg.seg,
            block=cfg.block,
            num_segs=cfg.num_segs,
            gather_segs=cfg.get("gather_segs", 0),
            infer_num_segs=cfg.get("infer_num_segs", 0),
            infer_gather_segs=cfg.get("infer_gather_segs", 0),
            compute_dtype=cfg.compute_dtype,
            knn_method=method,
            knn_on_device=on_device)

    def get_eval_net(self):
        """The evaluation net: exact neighbours unless ``eval_knn_method``
        opts into the fused path. It runs in float32 whatever
        ``compute_dtype`` says, and shares ``get_net()``'s state_dict."""
        method = self.cfg.get("eval_knn_method", None) or "exact"
        if method != "exact":
            log.warning("RandLANet evaluation uses APPROXIMATE neighbors "
                        "(eval_knn_method=%s); reported accuracy is not the "
                        "exact-path accuracy.", method)
        return self.get_net(knn_method=method)

    # ------------------------------------------------------------- training

    def get_loss(self, loss, results, inputs):
        """(loss, remapped labels [B * N], scores [B * N, num_classes]) of
        logits ``results`` [B, N, num_classes] against the raw labels
        ``inputs["labels"]`` [B, N]; ``loss`` is a ``SemSegLoss``."""
        cfg = self.cfg
        labels = inputs["labels"].reshape(-1)
        scores = results.reshape(-1, cfg.num_classes)
        remapped, valid = filter_valid_label(scores, labels, cfg.num_classes,
                                             cfg.ignored_label_inds)
        return (loss.weighted_cross_entropy(scores, remapped, valid),
                remapped, scores)

    def get_optimizer(self, cfg_pipeline, net):
        """(Adam over ``net``'s parameters, its learning-rate scheduler).

        The JAX package's ``optax.adam`` (betas 0.9 and 0.999, eps 1e-8)
        with the learning rate ``optimizer.lr`` (else ``adam_lr``, else
        1e-2) decayed by ``scheduler_gamma`` once per ``steps_per_epoch``
        updates; step the scheduler after every optimizer step. The JAX
        signature has no ``net``: optax transforms take the parameters at
        each update.
        """
        opt = dict(cfg_pipeline.get("optimizer") or {})
        lr = opt.get("lr", cfg_pipeline.get("adam_lr", 1e-2))
        optimizer = torch.optim.Adam(net.parameters(), lr=lr,
                                     betas=(0.9, 0.999), eps=1e-8)
        scheduler = exponential_lr(
            optimizer, cfg_pipeline.get("scheduler_gamma", 1.0),
            steps_per_epoch=cfg_pipeline.get("steps_per_epoch", 1))
        return optimizer, scheduler

    # ------------------------------------------------------------- host side

    def preprocess(self, data, attr):
        """Grid-subsample the cloud and build its KD-tree; for the test
        split also each input point's nearest subsampled point
        (``proj_inds``)."""
        cfg = self.cfg
        points = np.array(data["point"][:, 0:3], dtype=np.float32)
        if data.get("label") is None:
            labels = np.zeros((points.shape[0],), dtype=np.int32)
        else:
            labels = np.array(data["label"], dtype=np.int32).reshape((-1,))
        if data.get("feat") is None:
            sub_points, sub_labels = DataProcessing.grid_subsampling(
                points, labels=labels, grid_size=cfg.grid_size)
            sub_feat = None
        else:
            sub_points, sub_feat, sub_labels = (
                DataProcessing.grid_subsampling(
                    points, features=np.array(data["feat"], np.float32),
                    labels=labels, grid_size=cfg.grid_size))
        search_tree = cKDTree(sub_points)
        out = {"point": sub_points, "feat": sub_feat, "label": sub_labels,
               "search_tree": search_tree}
        if attr["split"] in ("test", "testing"):
            _, proj_inds = search_tree.query(points, k=1)
            out["proj_inds"] = np.asarray(proj_inds, np.int32).reshape(-1)
        return out

    def transform(self, data, attr, rng=None):
        """Draw a patch of ``num_points`` with ``trans_point_sampler``,
        recentre and normalise it, augment it on the training split, and
        build the network's inputs (features are the coordinates, then the
        cloud's own features). With ``knn_on_device`` False they also hold
        the k-NN pyramid of the augmented patch, built on the host: at each
        level the points' k nearest, the first N // ratio points as the
        subsample with their neighbour lists as pool indices, and each
        point's nearest subsample point."""
        cfg = self.cfg
        rng = rng or self.rng
        pc = data["point"].copy()
        label = data["label"].copy()
        feat = data["feat"].copy() if data["feat"] is not None else None

        pc, selected_idxs, _ = self.trans_point_sampler(
            pc=pc, feat=feat, label=label, search_tree=data["search_tree"],
            num_points=cfg.num_points, rng=rng)
        label = label[selected_idxs]
        if feat is not None:
            feat = feat[selected_idxs]

        augment_cfg = dict(cfg.get("augment", {}) or {})
        val_augment_cfg = {key: augment_cfg.pop(key)
                           for key in ("recenter", "normalize")
                           if key in augment_cfg}
        # recenter and normalize work in place on pc and feat; the random
        # steps draw from rng
        self.augmenter.augment(pc, feat, label, val_augment_cfg, seed=rng)
        if attr["split"] in ("training", "train"):
            pc, feat, label = self.augmenter.augment(pc, feat, label,
                                                     augment_cfg, seed=rng)

        feat = pc.copy() if feat is None else np.concatenate([pc, feat], 1)
        if cfg.in_channels != feat.shape[1]:
            raise RuntimeError(
                "Wrong feature dimension; set in_channels = 3 + feat dims")
        inputs = {"coords": pc.astype(np.float32),
                  "features": feat.astype(np.float32),
                  "labels": label.astype(np.int32),
                  "point_inds": np.asarray(selected_idxs, np.int32)}
        if not cfg.get("knn_on_device", True):
            inputs.update(self._host_pyramid(pc))
        return inputs

    def _host_pyramid(self, pc):
        """The k-NN pyramid of ``pc`` [N, 3], one array a level under the
        JAX package's keys."""
        cfg = self.cfg
        pyr = {"coords_pyramid": [], "neighbor_indices": [], "sub_idx": [],
               "interp_idx": []}
        for ratio in cfg.sub_sampling_ratio[:cfg.num_layers]:
            nbr = DataProcessing.knn_search(pc, pc, cfg.num_neighbors)
            sub = pc[:pc.shape[0] // ratio]
            pyr["coords_pyramid"].append(pc.astype(np.float32))
            pyr["neighbor_indices"].append(nbr)
            pyr["sub_idx"].append(nbr[:sub.shape[0]])
            pyr["interp_idx"].append(DataProcessing.knn_search(sub, pc, 1))
            pc = sub
        return pyr

    def update_probs(self, inputs, results, test_probs):
        """Blend each patch's class probabilities into the cloud's
        accumulator ``test_probs`` [N, num_classes] at its points, with
        weight 0.05 on the new ones."""
        test_smooth = 0.95
        results = np.asarray(results, np.float32)
        for b in range(results.shape[0]):
            logits = results[b].reshape(-1, self.cfg.num_classes)
            exp = np.exp(logits - logits.max(axis=-1, keepdims=True))
            probs = exp / exp.sum(axis=-1, keepdims=True)
            inds = np.asarray(inputs["point_inds"][b])
            test_probs[inds] = (test_smooth * test_probs[inds] +
                                (1 - test_smooth) * probs)
        return test_probs
