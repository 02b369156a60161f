"""Model FLOPs of the forwards, and the card's peak rate for a share of it.

Counterpart of ``open3d_ml_tpu/utils/flops.py``: ``randlanet_forward_flops``
and ``pointpillars_forward_flops`` are the same arithmetic. The count is
the algorithmic dense and convolution work (2 * rows * Cin * Cout a
Dense, 2 * H * W * Cin * Cout * kh * kw a convolution), not the neighbour
search, gathers, pools, normalisation or elementwise work; so the share
of peak of a gather-bound point-cloud net is low by construction.
``peak_flops_for`` gives the dense bf16 peak of a card by its
``torch.cuda.get_device_name()``, and raises for a card it does not know:
a default peak would put a wrong denominator under every share.
"""


def _dense(rows, cin, cout):
    return 2.0 * rows * cin * cout


def _conv2d(h_out, w_out, cin, cout, kh=3, kw=3):
    return 2.0 * h_out * w_out * cin * cout * kh * kw


def randlanet_forward_flops(num_points,
                            num_neighbors=16,
                            dim_output=(16, 64, 128, 256),
                            dim_features=8,
                            in_channels=3,
                            sub_sampling_ratio=(4, 4, 4, 4),
                            num_classes=19,
                            batch_size=1):
    """Dense-layer FLOPs of one RandLA-Net forward (models/randlanet.py).

    Counts every Linear layer of the net at its true row count (per-level
    point counts n_i = N / prod(ratios), K-axis layers at n_i*K rows).
    Neighbor search / gather / pool / upsample work is excluded (see
    module docstring).
    """
    k = num_neighbors
    dims = list(dim_output)
    ratios = list(sub_sampling_ratio)
    n_lvl = [num_points]
    for r in ratios:
        n_lvl.append(n_lvl[-1] // r)

    total = _dense(n_lvl[0], in_channels, dim_features)  # fc0
    f_in = dim_features
    for i, d in enumerate(dims):
        n = n_lvl[i]
        total += _dense(n, f_in, d // 2)            # mlp1
        total += _dense(n * k, 10, d // 2)          # lse1.mlp (rel feats)
        total += _dense(n * k, d, d)                # pool1.score_fn
        total += _dense(n, d, d // 2)               # pool1.mlp
        total += _dense(n * k, d // 2, d // 2)      # lse2.mlp
        total += _dense(n * k, d, d)                # pool2.score_fn
        total += _dense(n, d, d)                    # pool2.mlp
        total += _dense(n, d, 2 * d)                # mlp2
        total += _dense(n, f_in, 2 * d)             # shortcut
        f_in = 2 * d

    total += _dense(n_lvl[-1], 2 * dims[-1], 2 * dims[-1])  # bottleneck mlp

    # decoder: skip dims at levels [0..4] are
    # [2*d0 (pre-pool), 2*d0, 2*d1, 2*d2, 2*d3]
    enc_dims = [2 * dims[0]] + [2 * d for d in dims]
    f = 2 * dims[-1]
    for i in range(len(dims)):
        target = enc_dims[-i - 2]
        n = n_lvl[len(dims) - i - 1]
        total += _dense(n, target + f, target)
        f = target

    total += _dense(n_lvl[0], f, 64)                # fc1_0
    total += _dense(n_lvl[0], 64, 32)               # fc1_1
    total += _dense(n_lvl[0], 32, num_classes)      # fc1_3
    return total * batch_size


def pointpillars_forward_flops(max_points=32768,
                               feat_channels=(64,),
                               output_shape=(496, 432),
                               backbone=None,
                               neck=None,
                               num_classes=3,
                               num_anchors=6,
                               batch_size=1):
    """Dense/conv FLOPs of one PointPillars forward
    (models/point_pillars.py: point-major PFN -> SECOND -> FPN -> head).

    The PFN runs over the static max_points rows: padded rows are
    computed and masked, as the net runs them.
    """
    backbone = dict(backbone or {})
    neck = dict(neck or {})
    out_ch = list(backbone.get("out_channels", (64, 128, 256)))
    layer_nums = list(backbone.get("layer_nums", (3, 5, 5)))
    strides = list(backbone.get("layer_strides", (2, 2, 2)))
    n_out = list(neck.get("out_channels", (128, 128, 128)))
    n_up = list(neck.get("upsample_strides", (1, 2, 4)))

    total = 0.0
    # PFN: Dense 9 -> feat_channels chain over all points (decorated
    # features: xyzr + cluster-delta(3) + center-delta(2) = 9)
    cin = 9
    for i, ch in enumerate(feat_channels):
        units = ch if i == len(feat_channels) - 1 else ch // 2
        total += _dense(max_points, cin, units)
        cin = units

    # SECOND backbone
    h, w = output_shape
    cin = feat_channels[-1]
    feat_hw = []
    for i, num in enumerate(layer_nums):
        h, w = h // strides[i], w // strides[i]
        total += _conv2d(h, w, cin, out_ch[i])
        for _ in range(num):
            total += _conv2d(h, w, out_ch[i], out_ch[i])
        cin = out_ch[i]
        feat_hw.append((h, w))

    # FPN: ConvTranspose k=s counts 2*H_in*W_in*k^2*Cin*Cout
    for i, s in enumerate(n_up):
        h, w = feat_hw[i]
        if s >= 1:
            total += _conv2d(h, w, out_ch[i], n_out[i], kh=s, kw=s)
        else:
            ss = int(round(1 / s))
            total += _conv2d(h // ss, w // ss, out_ch[i], n_out[i],
                             kh=ss, kw=ss)

    # head: three 1x1 convs at the first (finest) FPN map size
    h, w = feat_hw[0]
    c = sum(n_out)
    total += _conv2d(h, w, c, num_anchors * num_classes, 1, 1)
    total += _conv2d(h, w, c, num_anchors * 7, 1, 1)
    total += _conv2d(h, w, c, num_anchors * 2, 1, 1)
    return total * batch_size


# dense bf16 tensor-core peak FLOP/s by a substring of the device name
# (NVIDIA's data sheet, H100 SXM, without sparsity, at its 700 W limit)
GPU_PEAK_BF16 = {"H100": 989e12}


def peak_flops_for(device_name):
    """The dense bf16 peak FLOP/s of the card named ``device_name``
    (``torch.cuda.get_device_name()``); raises ValueError for a card not
    in ``GPU_PEAK_BF16``."""
    for key, val in GPU_PEAK_BF16.items():
        if key.lower() in (device_name or "").lower():
            return val
    raise ValueError(f"no peak FLOP/s known for the device {device_name!r}; "
                     f"known: {sorted(GPU_PEAK_BF16)}")
