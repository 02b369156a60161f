"""The port's PointPillars network, decode and NMS (``open3d_ml_tpu_torch``)
against the JAX package.

Each flax module initialises its variables; BatchNorm statistics are then
replaced by numpy draws so that BN is not the identity. The same
variables go into the port (``load_jax_variables`` / ``jax_to_state_dict``)
and the same numpy inputs through both, in inference mode. Float32
results agree within 1e-5 relative L2 unless a test states otherwise.

The config is small (a 32 x 32 canvas, three stages of one convolution
each, a neck of strides 1, 2 and 4) but has two anchor sizes and two
classes, so the decode's cell, anchor and class order is held too.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp

import chip_smoke
from open3d_ml_tpu.models import PointPillars as JaxPointPillars
from open3d_ml_tpu.models import objdet_helper as jhelper
from open3d_ml_tpu.models import point_pillars as jpp
from open3d_ml_tpu.ops import iou as jiou
from open3d_ml_tpu.ops.bev import bev_scatter as jax_bev_scatter
from open3d_ml_tpu.ops.nms import multiclass_nms as jax_multiclass_nms
from open3d_ml_tpu.ops.nms import nms_bev as jax_nms_bev
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch.models import PointPillars
from open3d_ml_tpu_torch.models import objdet_helper as thelper
from open3d_ml_tpu_torch.models import point_pillars as tpp
from open3d_ml_tpu_torch.ops import iou as tiou
from open3d_ml_tpu_torch.ops.bev import bev_scatter
from open3d_ml_tpu_torch.ops.nms import multiclass_nms, nms_bev
from open3d_ml_tpu_torch.utils.convert_jax import (jax_to_state_dict,
                                                   load_jax_variables,
                                                   net_layout,
                                                   state_dict_to_jax)
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(
    point_cloud_range=[0, -8, -3, 16, 8, 1], classes=["Car", "Pedestrian"],
    voxelize={"voxel_size": [0.5, 0.5, 4], "max_num_points": 16,
              "max_voxels": [512, 512]},
    voxel_encoder={"feat_channels": [16]}, scatter={"output_shape": [32, 32]},
    backbone={"in_channels": 16, "out_channels": [16, 32, 64],
              "layer_nums": [1, 1, 1], "layer_strides": [2, 2, 2]},
    neck={"in_channels": [16, 32, 64], "out_channels": [16, 16, 16],
          "upsample_strides": [1, 2, 4]},
    head={"ranges": [[0, -8, -1.8, 16, 8, -1.8], [0, -8, -0.6, 16, 8, -0.6]],
          "sizes": [[1.7, 4.0, 1.5], [0.6, 0.8, 1.73]],
          "rotations": [0, 1.57], "iou_thr": [[0.3, 0.5]],
          "score_thr": 0.05},
    max_points=4096, max_gt=8)
B, P = 2, 4096
# (pillar_mode, compute_dtype) of the JAX net runs the tests share
RUNS = (("canvas", "float32"), ("compact", "float32"),
        ("canvas", "bfloat16"))
# the bf16 serving net vs the JAX net with its convolutions' outputs
# rounded to bf16, relative L2 of each head output (the most of the
# three). Over batch and weight seeds 0-9 (test_net_bfloat16_seeds) the
# sound net reads 1.3e-7 to 2.7e-4: the convolutions' sums in another
# order flip a bf16 rounding now and then, and the net carries it on. BN
# in bf16 reads 4.1e-3 and more, the head in bf16 2.7e-3 and more. One
# convolution left in float32 can read less than a flip (1.2e-4 at seed
# 0), so pp_cast_faults holds the casts themselves.
BF16_BOUND = 1e-3


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def round_bf16_conv_outputs(next_fun, args, kwargs, context):
    """A flax interceptor that rounds each bf16 convolution's output to
    bf16 (in float32, which XLA keeps). XLA's CPU backend has no bf16
    convolution: it runs one in float32 on the rounded operands and, as
    the float32 BatchNorm after it reads the result, never rounds the
    output (0.0034 relative L2 from the port on the small net). The port
    rounds it, as a bf16 convolution on the card does."""
    out = next_fun(*args, **kwargs)
    module = context.module
    if (isinstance(module, (nn.Conv, nn.ConvTranspose)) and
            context.method_name == "__call__" and
            module.dtype == jnp.bfloat16):
        return jax.lax.reduce_precision(out.astype(jnp.float32),
                                        exponent_bits=8, mantissa_bits=7)
    return out


def randomise_stats(tree, rng):
    return {k: (randomise_stats(v, rng) if isinstance(v, dict) else
                rng.normal(0.0, 0.2, v.shape).astype(np.float32)
                if k == "mean" else
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            for k, v in tree.items()}


def jax_variables(module, *args, seed=0, **kwargs):
    """numpy variables of a flax module, BN statistics drawn."""
    v = jax.jit(lambda *a: module.init({"params": jax.random.PRNGKey(seed)},
                                       *a, **kwargs))(*args)
    v = jax.tree_util.tree_map(np.asarray, dict(v))
    out = {"params": v["params"]}
    if "batch_stats" in v:
        out["batch_stats"] = randomise_stats(v["batch_stats"],
                                             np.random.default_rng(seed))
    return out


def apply_rounded(module, variables, *args, **kwargs):
    """``module.apply`` with each bf16 convolution's output rounded."""
    with nn.intercept_methods(round_bf16_conv_outputs):
        return module.apply(variables, *args, **kwargs)


def run_flax(module, *args, **kwargs):
    """(variables, output) of a flax module, jitted, bf16 convolutions'
    outputs rounded."""
    variables = jax_variables(module, *args, **kwargs)
    out = jax.jit(lambda v, *a: apply_rounded(module, v, *a, **kwargs))(
        variables, *args)
    return variables, out


# the JAX decode, mapped over the batch (SMALL's config), and the JAX NMS
jax_decode = jax.jit(jax.vmap(JaxPointPillars(**SMALL).get_bboxes))
jax_nms = jax.jit(lambda b, s, v: jax_nms_bev(b, s, 0.1, valid_mask=v))


JAX_BF16_NET = JaxPointPillars(**SMALL, pillar_mode="canvas",
                               compute_dtype="bfloat16").get_net()


@jax.jit
def jax_rounded_net(variables, batch):
    """The JAX serving net (SMALL, canvas, bf16) with its convolutions'
    outputs rounded."""
    return apply_rounded(JAX_BF16_NET, variables, batch, training=False)


@jax.jit
def jax_bf16_init(seed, batch):
    return JAX_BF16_NET.init({"params": jax.random.PRNGKey(seed)}, batch,
                             training=False)


def bf16_reading(got, want):
    """The most relative L2 of the three head outputs."""
    return max(rel_l2(g, w) for g, w in zip(got, want))


def load_module(module, variables):
    """A port module that is not a whole net: its tree at the root."""
    layout = dict(net_layout(module), scope=None)
    module.load_state_dict(jax_to_state_dict(variables, **layout),
                           strict=False)
    return module.eval()


def point_batch(rng, b=B, p=P, n=3000):
    """Points over a box a little larger than the range (some fall
    outside), the second sample shorter."""
    pts = np.zeros((b, p, 4), np.float32)
    pts[:, :n, 0] = rng.uniform(-1, 17, (b, n))
    pts[:, :n, 1] = rng.uniform(-9, 9, (b, n))
    pts[:, :n, 2] = rng.uniform(-3.5, 1.5, (b, n))
    pts[:, :n, 3] = rng.uniform(0, 1, (b, n))
    counts = np.array([n] + [n - n // 6] * (b - 1), np.int32)
    return {"point": pts, "point_count": counts}


def port_outputs(net, batch):
    with torch.no_grad():
        out = net({k: torch.from_numpy(v) for k, v in batch.items()})
    return [o.float().numpy() for o in out]


@pytest.fixture(scope="module")
def reference():
    """The batch, the JAX net's variables and its head outputs per run."""
    batch = point_batch(np.random.default_rng(0))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables, outputs = None, {}
    for mode, dtype in RUNS:
        net = JaxPointPillars(**SMALL, pillar_mode=mode,
                              compute_dtype=dtype).get_net()
        if variables is None:
            variables = jax_variables(net, jbatch, training=False)
        out = jax.jit(lambda v, b: net.apply(v, b, training=False))(
            variables, jbatch)
        outputs[mode, dtype] = [np.asarray(o, np.float32) for o in out]
    outputs["canvas", "bfloat16 rounded"] = [
        np.asarray(o, np.float32) for o in jax_rounded_net(variables, jbatch)]
    return {"batch": batch, "variables": variables, "outputs": outputs}


def port_net(variables, mode, dtype):
    net = PointPillars(**SMALL, pillar_mode=mode,
                       compute_dtype=dtype).get_net()
    return load_jax_variables(net, variables).eval()


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("last_layer", [True, False])
@pytest.mark.parametrize("mode", ["voxel", "point"])
def test_pfn_layer(mode, last_layer):
    """Both modes, as the last layer and as an inner one (pooled rows
    concatenated to each point's); the point-major mode with pillars at,
    below and above ``max_pts`` points and empty ones, where the pad value
    relu(BN(0)) is folded in or not."""
    rng = np.random.default_rng(1)
    flax_layer = jpp.PFNLayer(8, last_layer=last_layer)
    port = tpp.PFNLayer(9, 8, last_layer=last_layer)
    if mode == "voxel":
        x = rng.normal(0, 1, (30, 6, 9)).astype(np.float32)
        mask = rng.uniform(size=(30, 6)) < 0.6
        mask[:3] = False
        x = np.where(mask[..., None], x, 0).astype(np.float32)
        variables, want = run_flax(flax_layer, jnp.asarray(x),
                                   jnp.asarray(mask))
        got = load_module(port, variables)(torch.from_numpy(x),
                                           torch.from_numpy(mask))
    else:
        nseg, max_pts = 12, 4
        seg = rng.integers(0, nseg + 1, 200).astype(np.int32)  # nseg drops
        seg[:6] = 0  # six points in pillar 0, over max_pts
        seg[seg == 5] = 6  # pillar 5 empty
        counts = np.bincount(seg, minlength=nseg + 1)[:nseg].astype(np.int32)
        x = rng.normal(0, 1, (200, 9)).astype(np.float32)
        kw = dict(num_segments=nseg, max_pts=max_pts)
        variables, want = run_flax(flax_layer, jnp.asarray(x),
                                   seg_ids=jnp.asarray(seg),
                                   seg_counts=jnp.asarray(counts), **kw)
        got = load_module(port, variables)(
            torch.from_numpy(x), seg_ids=torch.from_numpy(seg),
            seg_counts=torch.from_numpy(counts), **kw)
    got = got.detach().numpy()
    assert got.shape == want.shape
    assert rel_l2(got, want) <= 1e-5


@pytest.mark.parametrize("counted", [False, True])
def test_pillar_feature_net_point_major(counted):
    """Point-major PFN over a canvas-like segment space: the counts made
    with the coordinate sums (canvas mode) or given (compact mode)."""
    rng = np.random.default_rng(2)
    pc = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
    pts = point_batch(rng, b=1, p=600, n=600)["point"][0]
    cx = np.floor((pts[:, 0] - pc[0]) / 0.5).astype(np.int32)
    cy = np.floor((pts[:, 1] - pc[1]) / 0.5).astype(np.int32)
    ok = (cx >= 0) & (cx < 32) & (cy >= 0) & (cy < 32)
    nv = 32 * 32
    seg = np.where(ok, cy * 32 + cx, nv).astype(np.int32)
    counts = (np.bincount(seg, minlength=nv + 1)[:nv].astype(np.int32)
              if counted else None)
    flax_net = jpp.PillarFeatureNet(feat_channels=(8, 16),
                                    voxel_size=(0.5, 0.5, 4),
                                    point_cloud_range=pc, max_pts=3)
    args = (jnp.asarray(pts), None if counts is None else jnp.asarray(counts))
    kw = dict(point_to_voxel=jnp.asarray(seg), num_voxels=nv)
    variables, want = run_flax(flax_net, *args, **kw)
    port = load_module(tpp.PillarFeatureNet(4, (8, 16), (0.5, 0.5, 4), pc, 3),
                       variables)
    got = port(torch.from_numpy(pts),
               None if counts is None else torch.from_numpy(counts),
               point_to_voxel=torch.from_numpy(seg), num_voxels=nv)
    assert rel_l2(got.detach().numpy(), want) <= 1e-5


def test_pillar_feature_net_voxel_major():
    rng = np.random.default_rng(3)
    pc = (0.0, -8.0, -3.0, 16.0, 8.0, 1.0)
    v, p = 40, 5
    coors = np.stack([rng.integers(0, 32, v), rng.integers(0, 32, v),
                      np.zeros(v, int)], 1).astype(np.int32)
    mask = rng.uniform(size=(v, p)) < 0.7
    counts = mask.sum(1).astype(np.int32)
    pts = np.concatenate([
        (coors[:, None, :2] + rng.uniform(0, 1, (v, p, 2))) * 0.5 +
        np.array(pc[:2]), rng.uniform(-3, 1, (v, p, 1)),
        rng.uniform(0, 1, (v, p, 1))], -1).astype(np.float32)
    pts = np.where(mask[..., None], pts, 0).astype(np.float32)
    flax_net = jpp.PillarFeatureNet(feat_channels=(8,),
                                    voxel_size=(0.5, 0.5, 4),
                                    point_cloud_range=pc)
    args = [jnp.asarray(a) for a in (pts, counts, coors, mask)]
    variables, want = run_flax(flax_net, *args)
    port = load_module(tpp.PillarFeatureNet(4, (8,), (0.5, 0.5, 4), pc),
                       variables)
    got = port(*[torch.from_numpy(a) for a in (pts, counts, coors, mask)])
    assert rel_l2(got.detach().numpy(), want) <= 1e-5


def test_bev_scatter():
    """Cells unique per row, dropped pillars at cells past the canvas
    (some far past it): equal to the JAX scatter, bit for bit."""
    rng = np.random.default_rng(4)
    b, v, c, cells_n = 2, 50, 6, 200
    feats = rng.normal(0, 1, (b, v, c)).astype(np.float32)
    cells = np.stack([rng.permutation(cells_n + 40)[:v]
                      for _ in range(b)]).astype(np.int32)
    cells[0, :5] = cells_n + 1000 + np.arange(5)
    want = jax_bev_scatter(jnp.asarray(feats), jnp.asarray(cells), cells_n)
    got = bev_scatter(torch.from_numpy(feats), torch.from_numpy(cells),
                      cells_n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_second(dtype):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 16, 24, 8)).astype(np.float32)  # NHWC
    cfg = dict(out_channels=(8, 16), layer_nums=(1, 2), layer_strides=(2, 1))
    flax_net = jpp.SECOND(**cfg, compute_dtype=dtype)
    variables, want = run_flax(flax_net, jnp.asarray(x))
    port = load_module(tpp.SECOND(8, **cfg, compute_dtype=dtype), variables)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).detach().float().numpy()
        assert g.shape == w.shape
        assert rel_l2(g, w) <= (1e-5 if dtype == "float32" else BF16_BOUND)


def test_secondfpn_transposed_kernel_flip():
    """Strides 1, 2 and 4: the transposed convolutions need flax's kernel
    flipped in space; a stride 1/2 stage is a strided convolution."""
    rng = np.random.default_rng(6)
    xs = [rng.normal(0, 1, (2, 16 // s, 12 // s, c)).astype(np.float32)
          for s, c in ((1, 8), (2, 16), (4, 16), (1, 8))]
    cfg = dict(out_channels=(8, 8, 4, 4), upsample_strides=(1, 2, 4, 0.5),
               use_conv_for_no_stride=False)
    flax_net = jpp.SECONDFPN(**cfg)
    jxs = [jnp.asarray(x) for x in xs]
    jxs[3] = jnp.asarray(rng.normal(0, 1, (2, 32, 24, 8)).astype(np.float32))
    variables, want = run_flax(flax_net, jxs)
    port = load_module(tpp.SECONDFPN((8, 16, 16, 8), **cfg), variables)
    got = port([torch.tensor(np.asarray(x)).permute(0, 3, 1, 2)
                for x in jxs])
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape
    assert rel_l2(got, want) <= 1e-5
    kernel = variables["params"]["deblock2_up"]["kernel"]  # [4, 4, in, out]
    weight = port.deblock2_up.weight.detach().numpy()  # [in, out, 4, 4]
    np.testing.assert_array_equal(weight[:, :, 0, 0], kernel[3, 3])


# -------------------------------------------------------------- whole net

@pytest.mark.parametrize("mode", ["canvas", "compact"])
def test_net_float32(reference, mode):
    """The whole net from points to head outputs, [B, H, W, A * x]."""
    net = port_net(reference["variables"], mode, "float32")
    got = port_outputs(net, reference["batch"])
    for g, w in zip(got, reference["outputs"][mode, "float32"]):
        assert g.shape == w.shape
        assert rel_l2(g, w) <= 1e-5


def test_canvas_equals_compact_when_no_cap_binds(reference):
    """With fewer than 512 occupied pillars and none of 16 points, the two
    pillarizations compute the same function (``tests/test_ops.py`` holds
    the JAX nets to it)."""
    batch = point_batch(np.random.default_rng(12), n=400)
    pts = torch.from_numpy(batch["point"])
    for i, n in enumerate(batch["point_count"]):
        vd = tpp.voxelize(pts[i, :n, :3], (0.5, 0.5, 4), (0, -8, -3),
                          (16, 8, 1), 1024, 1024)
        assert vd.num_voxels < 512 and vd.num_points_per_voxel.max() < 16
    a, b = (port_outputs(port_net(reference["variables"], m, "float32"),
                         batch) for m in ("canvas", "compact"))
    for x, y in zip(a, b):
        assert rel_l2(x, y) <= 1e-5


def test_net_bfloat16(reference):
    """The serving net at bf16: the PFN in float32, the pooled canvas and
    the convolutions in bf16, BN and the head in float32, each cast where
    ``chip_smoke.pp_cast_faults`` looks. Against the JAX net with its
    convolutions' outputs rounded within ``BF16_BOUND``; against the JAX
    net as XLA runs it on the CPU (outputs unrounded) within 1e-2
    (measured 0.0034); against the port's float32 net between 1e-4 and
    1e-2 (measured 0.0040)."""
    variables, batch = reference["variables"], reference["batch"]
    outputs = reference["outputs"]
    net = port_net(variables, "canvas", "bfloat16")
    assert chip_smoke.pp_cast_faults(
        net, {k: torch.from_numpy(v) for k, v in batch.items()}) == []
    got = port_outputs(net, batch)
    f32 = port_outputs(port_net(variables, "canvas", "float32"), batch)
    assert all(np.isfinite(g).all() for g in got)
    assert bf16_reading(got, outputs["canvas", "bfloat16 rounded"]) <= \
        BF16_BOUND
    for g, w, f in zip(got, outputs["canvas", "bfloat16"], f32):
        assert rel_l2(g, w) <= 1e-2
        assert 1e-4 <= rel_l2(g, f) <= 1e-2


@pytest.mark.parametrize("seed", range(1, 10))
def test_net_bfloat16_seeds(seed, capsys):
    """Other batches and weights: the sound bf16 net within
    ``BF16_BOUND`` of the JAX net with rounded outputs, BN in bf16 and the
    head in bf16 past it, the casts pinned."""
    batch = point_batch(np.random.default_rng(seed))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax.tree_util.tree_map(np.asarray,
                                       dict(jax_bf16_init(seed, jbatch)))
    variables["batch_stats"] = randomise_stats(variables["batch_stats"],
                                               np.random.default_rng(seed))
    want = jax_rounded_net(variables, jbatch)
    net = port_net(variables, "canvas", "bfloat16")
    assert chip_smoke.pp_cast_faults(
        net, {k: torch.from_numpy(v) for k, v in batch.items()}) == []
    readings = {"sound": bf16_reading(port_outputs(net, batch), want)}
    for fault in ("bn_bf16", "head_bf16"):
        with chip_smoke.planted_cast(net, fault):
            readings[fault] = bf16_reading(port_outputs(net, batch), want)
    with capsys.disabled():
        print(f"\nseed {seed}: " + ", ".join(
            f"{k} {v:.3e}" for k, v in readings.items()))
    assert readings["sound"] <= BF16_BOUND
    assert readings["bn_bf16"] > BF16_BOUND
    assert readings["head_bf16"] > BF16_BOUND


SMALL_CONVS = tuple(chip_smoke.pp_convs(PointPillars(**SMALL).get_net()))


@pytest.mark.parametrize("fault", chip_smoke.PP_FAULTS + SMALL_CONVS)
def test_net_bfloat16_planted_cast(reference, fault, capsys, monkeypatch):
    """Each wrong cast ``chip_smoke.planted_cast`` plants (BN or the head
    in bf16, the canvas or one convolution in float32) is caught by the
    cast pin and by the card's stage check (``pp_stage_shares``, here
    against the sound net on the CPU); BN and the head in bf16 by
    ``BF16_BOUND`` too. The canvas in float32 moves no value (the first
    convolution rounds it to bf16), and one convolution in float32 may
    move them less than a flip does (see ``BF16_BOUND``)."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    batch = reference["batch"]
    x = {k: torch.from_numpy(v) for k, v in batch.items()}
    net = port_net(reference["variables"], "canvas", "bfloat16")
    stages = chip_smoke.pp_stages(net, x)
    sound = chip_smoke.pp_stage_shares(net, stages, x)
    assert len(sound) == 1 + len(SMALL_CONVS) + 3
    assert max(sound.values()) == 0
    with chip_smoke.planted_cast(net, fault):
        faults = chip_smoke.pp_cast_faults(net, x)
        shares = chip_smoke.pp_stage_shares(net, stages, x)
        got = port_outputs(net, batch)
    assert max(shares.values()) > chip_smoke.PP_BF16_STAGE_SHARE
    reading = bf16_reading(got,
                           reference["outputs"]["canvas", "bfloat16 rounded"])
    with capsys.disabled():
        print(f"\nplanted {fault}: relative L2 {reading:.3e}, cast pin "
              f"{faults}")
    assert faults
    if fault == "canvas_f32":
        assert reading <= BF16_BOUND
    elif fault in ("bn_bf16", "head_bf16"):
        assert reading > BF16_BOUND
    # the context restores the sound net
    assert chip_smoke.pp_cast_faults(net, x) == []


def test_head_layout_pinned(reference):
    """The head's outputs read as cell, anchor (size, rotation), class:
    moving one logit of the port's output to a known (cell, anchor,
    class) moves the same decoded candidate as in the JAX decode."""
    cls, reg, dirs = (o.copy() for o in
                      reference["outputs"]["canvas", "float32"])
    cls[:] = -10.0
    h, w, a_c = cls.shape[1:]
    y, x, anchor, c = 5, 7, 3, 1  # size 1, rotation 1, class Pedestrian
    cls[0, y, x, anchor * 2 + c] = 10.0
    model = PointPillars(**SMALL)
    boxes, scores, labels, valid = model.get_bboxes(
        *[torch.from_numpy(o) for o in (cls, reg, dirs)])
    jout = jax_decode(*[jnp.asarray(o) for o in (cls, reg, dirs)])
    kept = np.flatnonzero(valid[0].numpy())
    assert len(kept) == 1 and labels[0, kept[0]] == 1
    np.testing.assert_array_equal(kept, np.flatnonzero(np.asarray(jout[3][0])))
    anchors = model._anchors()  # [H, W, S, R, 7]
    np.testing.assert_allclose(boxes[0, kept[0], :2].numpy(),
                               anchors[y, x, 1, 1, :2], atol=2.0)


# ----------------------------------------------------- anchors, boxes, IoU

def test_anchors_exact():
    kw = dict(ranges=SMALL["head"]["ranges"], sizes=SMALL["head"]["sizes"],
              rotations=SMALL["head"]["rotations"])
    want = jhelper.Anchor3DRangeGenerator(**kw).grid_anchors((16, 16))
    got = thelper.Anchor3DRangeGenerator(**kw).grid_anchors((16, 16))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (16, 16, 2, 2, 7)
    np.testing.assert_array_equal(PointPillars(**SMALL)._anchors(),
                                  JaxPointPillars(**SMALL)._anchors())


def test_bbox_coder():
    """Encode and decode: the same arithmetic in the same order. exp and
    log of XLA's CPU runtime and of PyTorch differ in the last bit, so the
    comparison allows 1e-6 of each box's scale; the coordinate
    transforms, the BEV boxes and limit_period are bit-equal."""
    rng = np.random.default_rng(7)
    anchors = np.concatenate([rng.uniform(-10, 10, (500, 3)),
                              rng.uniform(0.5, 4, (500, 3)),
                              rng.uniform(-4, 4, (500, 1))], 1)
    anchors = anchors.astype(np.float32)
    deltas = rng.normal(0, 0.5, (500, 7)).astype(np.float32)
    ja, jd = jnp.asarray(anchors), jnp.asarray(deltas)
    ta, td = torch.from_numpy(anchors), torch.from_numpy(deltas)
    boxes = np.asarray(jax.jit(jhelper.BBoxCoder.decode)(ja, jd))
    got = thelper.BBoxCoder.decode(ta, td).numpy()
    np.testing.assert_allclose(got, boxes, rtol=1e-6, atol=1e-6)
    want = np.asarray(jax.jit(jhelper.BBoxCoder.encode)(ja, jnp.asarray(boxes)))
    got = thelper.BBoxCoder.encode(ta, torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, deltas, atol=2e-5)
    for name in ("box3d_to_bev", "box3d_to_bev2d"):
        np.testing.assert_array_equal(
            getattr(thelper, name)(ta).numpy(),
            np.asarray(getattr(jhelper, name)(ja)))
    np.testing.assert_array_equal(
        thelper.limit_period(ta[:, 6], 1, np.pi).numpy(),
        np.asarray(jhelper.limit_period(ja[:, 6], 1, np.pi)))
    five = anchors[:, [0, 1, 3, 4, 6]]
    np.testing.assert_array_equal(
        thelper.xywhr_to_xyxyr(torch.from_numpy(five)).numpy(),
        np.asarray(jhelper.xywhr_to_xyxyr(jnp.asarray(five))))


def bev_boxes(rng, n, spread=4.0):
    b = np.zeros((n, 5), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2:4] = rng.uniform(0.5, 3, (n, 2))
    b[:, 4] = rng.uniform(-3.2, 3.2, n)
    return b


def test_iou_bev_and_3d():
    """The numpy path equals the JAX package's numpy path bit for bit
    (mAP rides it); the torch path equals the jitted jnp one within 1e-5
    (XLA fuses the corner and shoelace products into multiply-adds:
    measured 1.7e-6 here), and touching and identical boxes give 0 and
    1."""
    rng = np.random.default_rng(8)
    a, b = bev_boxes(rng, 40), bev_boxes(rng, 30)
    a[1] = b[1]  # identical
    a[2] = b[2] + np.array([b[2, 2], 0, 0, 0, 0], np.float32)
    a[2, 4] = b[2, 4] = 0  # touching along x
    np.testing.assert_array_equal(tiou.iou_bev(a, b), jiou.iou_bev(a, b))
    want = np.asarray(jax.jit(lambda u, v: jiou.iou_bev(u, v, xp=jnp))(
        jnp.asarray(a), jnp.asarray(b)))
    got = tiou.iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert abs(got[1, 1] - 1) <= 1e-6 and got[2, 2] <= 1e-6
    a3 = np.concatenate([a[:, :2], rng.uniform(-1, 1, (40, 1)),
                         a[:, 2:3], rng.uniform(1, 2, (40, 1)),
                         a[:, 3:]], 1).astype(np.float32)
    b3 = np.concatenate([b[:, :2], rng.uniform(-1, 1, (30, 1)),
                         b[:, 2:3], rng.uniform(1, 2, (30, 1)),
                         b[:, 3:]], 1).astype(np.float32)
    np.testing.assert_array_equal(tiou.iou_3d(a3, b3), jiou.iou_3d(a3, b3))
    got = tiou.iou_3d(torch.from_numpy(a3), torch.from_numpy(b3)).numpy()
    np.testing.assert_allclose(got, jiou.iou_3d(a3, b3), atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_nms_bev(masked):
    """Crowded boxes with tied scores (ties to the lower index): the
    keep masks equal JAX's, for one row and for a batch of rows."""
    rng = np.random.default_rng(9)
    rows = []
    for r in range(3):
        boxes = bev_boxes(rng, 60, spread=3.0)
        scores = rng.uniform(0, 1, 60).astype(np.float32)
        scores[10:14] = scores[3]
        valid = rng.uniform(size=60) < 0.8 if masked else None
        want = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                  jnp.asarray(valid if masked else
                                              np.ones(60, bool))))
        tkw = {} if valid is None else {"valid_mask":
                                        torch.from_numpy(valid)}
        got = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                      0.1, **tkw).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < (60 if valid is None else valid.sum())
        rows.append((boxes, scores, valid, want))
    boxes, scores, valid, want = (np.stack([r[i] for r in rows])
                                  if rows[0][i] is not None else None
                                  for i in range(4))
    tkw = {} if valid is None else {"valid_mask": torch.from_numpy(valid)}
    got = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores), 0.1,
                  **tkw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_nms_bev_suppression_chain():
    """Each box overlaps only the next and the scores fall along the
    chain: greedy NMS keeps every other box, which the port's fixed-point
    rounds reach only after settling the chain box by box."""
    n = 40
    boxes = np.zeros((n, 5), np.float32)
    boxes[:, 0] = np.arange(n) * 1.5
    boxes[:, 2:4] = 2.0
    scores = np.linspace(1, 0.1, n).astype(np.float32)
    want = np.asarray(jax_nms_bev(jnp.asarray(boxes), jnp.asarray(scores),
                                  0.1))
    got = nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores), 0.1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.arange(n) % 2 == 0)


def test_multiclass_nms():
    rng = np.random.default_rng(10)
    boxes = bev_boxes(rng, 50, spread=3.0)
    scores = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    valid = rng.uniform(size=50) < 0.9
    want = jax.jit(lambda b, s, v: jax_multiclass_nms(b, s, 0.2, 0.3,
                                                      valid_mask=v))(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    got = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                         0.2, 0.3, valid_mask=torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("run", RUNS[:2])
def test_get_bboxes(reference, run):
    """The JAX head outputs through both decodes: the same kept (class,
    candidate) set and labels; scores and boxes within 1e-6 (the sigmoid
    and exp of XLA's CPU runtime and of PyTorch differ in the last
    bit)."""
    outs = reference["outputs"][run]
    model = PointPillars(**SMALL)
    got = [t.numpy() for t in model.get_bboxes(
        *[torch.from_numpy(o) for o in outs])]
    want = [np.asarray(t) for t in
            jax_decode(*[jnp.asarray(o) for o in outs])]
    m = 100 * len(SMALL["classes"])
    assert got[0].shape == (B, m, 7) and got[3].shape == (B, m)
    np.testing.assert_array_equal(got[3], want[3])
    assert got[3].sum() > 0
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got[0][got[3]], want[0][want[3]], atol=1e-6,
                               rtol=1e-6)


# ------------------------------------------------------------- conversion

def test_convert_jax_round_trip(reference):
    """PointPillars' tree sits at the root; every leaf maps, the
    transposed convolutions flip and the inverse map restores the tree."""
    variables = reference["variables"]
    net = PointPillars(**SMALL).get_net()
    layout = net_layout(net)
    assert layout["scope"] is None
    assert layout["transposed"] == {"neck.deblock0_up", "neck.deblock1_up",
                                    "neck.deblock2_up"}
    load_jax_variables(net, variables)
    back = state_dict_to_jax(net.state_dict(), **layout)
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat(variables))
    got = dict(flat(back))
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))
    sd = jax_to_state_dict(back, **layout)
    for key, value in net.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(sd[key], value), key
    assert net.backbone.block0_bn0.eps == 1e-3
    assert net.backbone.block0_bn0.momentum == 0.01


def test_training_not_ported():
    """The training methods, which raised before training was ported, run
    on the small config: the train split's ``preprocess`` (no augment
    section: the range filter only), ``assign_bboxes``, ``get_loss`` and
    ``get_optimizer``. ``test_torch_pp_train.py`` holds them to the JAX
    package."""
    model = PointPillars(**SMALL)
    data = {"point": np.array([[1, 0, 0, 1], [20, 0, 0, 1]], np.float32),
            "bounding_boxes": []}
    out = model.preprocess(data, {"split": "training"})
    np.testing.assert_array_equal(out["point"], data["point"][:1])
    assert out["bbox_objs"] == []
    boxes = torch.zeros((1, 2, 7))
    boxes[0, 0] = torch.tensor([4.0, 0.0, -1.8, 1.7, 4.0, 1.5, 0.0])
    inputs = {"bboxes": boxes, "labels": torch.tensor([[0, 2]]),
              "bbox_count": torch.tensor([1])}
    targets = model.assign_bboxes(inputs["bboxes"], inputs["labels"],
                                  inputs["bbox_count"])
    cells = 16 * 16 * 2 * 2
    assert targets["target_deltas"].shape == (cells, 7)
    assert targets["pos_mask"].sum() > 0
    net = model.get_net()
    outs = [torch.zeros((1, 16, 16, 4 * k)) for k in (2, 7, 2)]
    losses = model.get_loss(outs, inputs)
    assert all(torch.isfinite(v) for v in losses.values())
    optimizer, _ = model.get_optimizer({}, net)
    assert isinstance(optimizer, torch.optim.AdamW)


# --------------------------------------------------------- the KITTI net

@pytest.mark.slow
def test_kitti_eval_net_full_width():
    """The shipped KITTI config's eval net (compact, float32) at B=1 on
    20,000 points uniform over its range, against the JAX eval net."""
    from pathlib import Path
    cfg = Config.load_from_file(Path(__file__).resolve().parents[1] /
                                "open3d_ml_tpu/configs/pointpillars_kitti.yml")
    kw = {k: v for k, v in cfg.model.to_dict().items()
          if k not in ("name", "ckpt_path", "augment")}
    rng = np.random.default_rng(11)
    pc = kw["point_cloud_range"]
    pts = np.zeros((1, kw["max_points"], 4), np.float32)
    for i in range(3):
        pts[0, :20000, i] = rng.uniform(pc[i], pc[i + 3], 20000)
    pts[0, :20000, 3] = rng.uniform(0, 1, 20000)
    batch = {"point": pts, "point_count": np.array([20000], np.int32)}
    jnet = JaxPointPillars(**kw).get_eval_net()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax_variables(jnet, jbatch, training=False)
    want = jax.jit(lambda v, b: jnet.apply(v, b, training=False))(
        variables, jbatch)
    net = load_jax_variables(PointPillars(**kw).get_eval_net(), variables)
    got = port_outputs(net.eval(), batch)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, 248, 216, g.shape[-1])
        assert rel_l2(g, np.asarray(w)) <= 1e-5
