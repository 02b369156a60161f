"""RandLA-Net for semantic segmentation, on the fused bucket path.

Counterpart of ``open3d_ml_tpu/models/randlanet.py`` at
``knn_method="fused"``: fc0 + BN, four LocalFeatureAggregation encoder
stages with 4x subsampling, a shared-MLP bottleneck, four decoder stages
with nearest-neighbour upsampling and skip concatenation, and a 3-layer
head. The network runs on the whole [B, N, C] batch in Hilbert-sorted
order; every neighbour, pool and upsample read is a bucket gather
(``ops/cuda/bucket.py``), and the logits come back in the caller's order.

Layout is channels-last [..., C], as in the JAX package. The parameter
names follow the JAX variable tree (``utils/convert_jax.py`` maps one onto
the other). BatchNorm follows torch semantics (momentum 0.01, eps 1e-6).

With ``compute_dtype="bfloat16"`` every Linear but the last computes in
bfloat16, BatchNorm and everything after it in float32, and the gathers
round the values they read to bfloat16, as the TPU kernel did.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bucket import build_bucket_pyramid, pad_seg
from ..ops.cuda.bucket import gather_bucket
from ..utils.registry import MODEL
from .base_model import BaseModel


def _dense(linear, x, dtype):
    """``linear`` applied in ``dtype`` (float32 when None): inputs, weight
    and bias are all cast to it, as flax's Dense does."""
    dt = dtype or torch.float32
    bias = None if linear.bias is None else linear.bias.to(dt)
    return F.linear(x.to(dt), linear.weight.to(dt), bias)


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
        return gather_bucket(pad_seg(v, self.seg).contiguous(), seg_ids, rel,
                             seg=self.seg, qblock=qblock,
                             round_bf16=self.round_bf16)

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


class SharedMLP(nn.Module):
    """Linear + BatchNorm + LeakyReLU over the channel axis."""

    def __init__(self, in_dim, out_dim, bn=True, slope=0.2, dtype=None):
        super().__init__()
        self.conv = nn.Linear(in_dim, out_dim)
        self.batch_norm = (nn.BatchNorm1d(out_dim, eps=1e-6, momentum=0.01)
                           if bn else None)
        self.slope = slope
        self.dtype = dtype

    def forward(self, x):
        x = _dense(self.conv, x, self.dtype)
        if self.batch_norm is not None:
            # float32 parameters promote the (possibly bf16) product
            x = self.batch_norm(x.float().reshape(-1, x.shape[-1])).reshape(
                x.shape)
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
    """The RandLA-Net network on the fused bucket path.

    ``forward({"coords": [B, N, 3], "features": [B, N, in_channels]})``
    returns logits [B, N, num_classes] in the caller's point order. In eval
    mode the pyramid uses the inference table budget (``infer_num_segs``,
    ``infer_gather_segs``; 0 keeps the training budget).
    """

    def __init__(self, num_neighbors, num_layers, num_classes, in_channels,
                 dim_features, dim_output, sub_sampling_ratio, seg, block,
                 num_segs, gather_segs, infer_num_segs, infer_gather_segs,
                 compute_dtype):
        super().__init__()
        if compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype {compute_dtype!r}")
        self.num_neighbors = num_neighbors
        self.num_layers = num_layers
        self.sub_sampling_ratio = list(sub_sampling_ratio)
        self.seg, self.block = seg, block
        self.num_segs, self.gather_segs = num_segs, gather_segs
        self.infer_num_segs = infer_num_segs
        self.infer_gather_segs = infer_gather_segs
        self.round_bf16 = compute_dtype == "bfloat16"
        cdt = torch.bfloat16 if self.round_bf16 else None
        self.cdt = cdt

        self.fc0 = nn.Linear(in_channels, dim_features)
        self.bn0 = nn.BatchNorm1d(dim_features, eps=1e-6, momentum=0.01)
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
        self.dropout = nn.Dropout(0.5)
        self.fc1_3 = SharedMLP(32, num_classes, bn=False, slope=None)

    def _levels(self, coords):
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
        levels, perm = self._levels(inputs["coords"])
        feat = inputs["features"]
        # sorted order from here to the head
        feat = torch.gather(feat, 1,
                            perm[..., None].expand(-1, -1, feat.shape[-1]))
        feat = _dense(self.fc0, feat, self.cdt).float()
        feat = self.bn0(feat.reshape(-1, feat.shape[-1])).reshape(feat.shape)
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
        # back to the caller's order: out[perm[i]] = scores[i]
        return torch.empty_like(scores).scatter_(
            1, perm[..., None].expand_as(scores), scores)


# knobs of the JAX model that the port has no path for, with the one value
# the port implements
_PORTED_ONLY = {"knn_method": "fused", "knn_on_device": True,
                "up_mode": "derive", "presorted": False, "gather_qblock": 0,
                "up_segs": 0}


@MODEL.register_module()
class RandLANet(BaseModel):
    """RandLA-Net model: configuration plus the network (``get_net``).

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

    def get_net(self):
        """Build the network (``RandLANetNet``)."""
        cfg = self.cfg
        for key, value in _PORTED_ONLY.items():
            if cfg.get(key, value) != value:
                raise NotImplementedError(
                    f"RandLANet {key}={cfg[key]!r} is not ported; the port "
                    f"runs {key}={value!r}")
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
            compute_dtype=cfg.compute_dtype)
