"""The port's reference-checkpoint converters against the JAX package's.

Each converter maps a reference ``state_dict`` onto the port's names. On
the synthetic reference-shaped state_dicts of ``tests/test_convert.py``
its output equals the JAX converter's flax tree after
``jax_to_state_dict``, key for key and value for value (the port adds a
``num_batches_tracked`` of 0 beside each BatchNorm that counts batches),
and a strict ``load_state_dict`` of the port's net takes it. RandLA-Net's
and PointPillars' logits on the converted weights equal the JAX nets'.
``convert_checkpoint`` reads a ``.pth`` and dispatches as JAX does.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
import test_convert as jtc
from open3d_ml_tpu.models import PointPillars as JaxPointPillars
from open3d_ml_tpu.models import PointRCNN as JaxPointRCNN
from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
from open3d_ml_tpu.utils import convert_torch as jct
from open3d_ml_tpu_torch.models import (KPFCNN, PointPillars, PointRCNN,
                                        PointTransformer, RandLANet,
                                        SparseConvUnet)
from open3d_ml_tpu_torch.utils import convert_torch as tct
from open3d_ml_tpu_torch.utils.convert_jax import (jax_to_state_dict,
                                                   net_layout)
from test_torch_ops import lattice_cloud
from torch_threads import one_torch_thread  # noqa: F401

COUNT = "num_batches_tracked"
# RandLA-Net at the widths of test_convert's state_dict
RANDLA = dict(num_points=1024, num_classes=19, ignored_label_inds=[0],
              in_channels=3, dim_features=8, dim_output=[16, 64, 128, 256],
              sub_sampling_ratio=[4, 4, 4, 4])
# PointPillars at the widths of test_convert's end-to-end mirror
PP_MIRROR = jtc.TestPointPillarsEndToEndParity
PP_WIDE = dict(
    point_cloud_range=list(PP_MIRROR.PC_RANGE), classes=["car"],
    voxelize={"voxel_size": list(PP_MIRROR.VOXEL), "max_num_points": 32,
              "max_voxels": [4000, 4000]},
    voxel_encoder={"feat_channels": [64]},
    scatter={"output_shape": [PP_MIRROR.NY, PP_MIRROR.NX]},
    backbone={"in_channels": 64, "out_channels": [64, 128, 256],
              "layer_nums": [3, 5, 5], "layer_strides": [2, 2, 2]},
    neck={"in_channels": [64, 128, 256], "out_channels": [128, 128, 128],
          "upsample_strides": [1, 2, 4]},
    head={"ranges": [list(PP_MIRROR.PC_RANGE)], "sizes": [[1.6, 3.9, 1.56]],
          "rotations": [0, 1.5707963]})
# a small PointPillars of two classes, for the logits
PP_SMALL = dict(
    point_cloud_range=[0.0, -5.12, -3.0, 10.24, 5.12, 1.0],
    classes=["car", "pedestrian"], compute_dtype="float32",
    voxelize={"voxel_size": [0.32, 0.32, 4.0], "max_num_points": 16,
              "max_voxels": [512, 512]},
    voxel_encoder={"feat_channels": [16]},
    scatter={"output_shape": [32, 32]},
    backbone={"out_channels": [16, 32, 32], "layer_nums": [1, 1, 1],
              "layer_strides": [2, 2, 2]},
    neck={"out_channels": [16, 16, 16], "upsample_strides": [1, 2, 4]},
    head={"ranges": [[0.0, -5.12, -1.0, 10.24, 5.12, -1.0]] * 2,
          "sizes": [[1.6, 3.9, 1.56], [0.6, 0.8, 1.73]],
          "rotations": [0, 1.57], "iou_thr": [[0.45, 0.6], [0.35, 0.5]]})
# PointRCNN at test_convert's converter config
PRCNN = dict(
    mode="RCNN", npoints=512,
    rpn={"backbone": {"npoints": [128, 32, 8, 2]},
         "head": {"nms_pre": 256, "nms_post": 32,
                  "mean_size": [1.52, 1.63, 3.88]}},
    rcnn={"SA_config": {"npoints": [32, 8, -1], "radius": [0.2, 0.4, 100],
                        "nsample": [16, 16, 16],
                        "mlps": [[64, 64], [64, 128], [128, 256]]},
          "xyz_up_layer": [128, 128], "cls_out_ch": [128],
          "reg_out_ch": [128],
          "head": {"nms_pre": 32, "nms_post": 32, "get_ry_fine": True,
                   "loc_scope": 1.5, "num_head_bin": 9,
                   "mean_size": [1.52, 1.63, 3.88], "nms_thres": 0.1},
          "target_head": {"num_points": 64, "roi_per_image": 16}})


def _numpy(sd):
    return {k: np.asarray(v) for k, v in sd.items()}


def _he_scaled(sd, rng):
    """``sd`` with each weight scaled by sqrt(2 / fan_in) (a 1x1 transposed
    convolution's fan-in is its first axis) and each BatchNorm's running
    statistics drawn away from the identity: test_convert's standard
    normal weights grow the RandLA logits to ~1e19, where float32's
    rounding, not the conversion, sets the difference."""
    out = {}
    for key, value in sd.items():
        value = np.asarray(value, np.float32)
        if key.endswith("running_mean"):
            value = rng.normal(0, 0.2, value.shape).astype(np.float32)
        elif key.endswith("running_var"):
            value = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key.endswith("weight") and value.ndim >= 2:
            fan_in = (value.shape[0] if key.startswith("decoder.")
                      else int(np.prod(value.shape[1:])))
            value = value * np.float32(np.sqrt(2 / fan_in))
        out[key] = torch.from_numpy(value)
    return out


def _equal_to_jax(got, tree, net):
    """``got`` without its batch counts equals ``tree`` after
    ``jax_to_state_dict`` for ``net``'s layout, key for key and bit for
    bit; every count is 0 beside a running mean; a strict load of ``got``
    into ``net`` succeeds."""
    want = jax_to_state_dict(tree, **net_layout(net))
    counts = {k for k in got if k.endswith(COUNT)}
    assert set(got) - counts == set(want)
    for key, value in want.items():
        assert got[key].dtype == torch.float32, key
        np.testing.assert_array_equal(got[key].numpy(), value.numpy(),
                                      err_msg=key)
    for key in counts:
        assert got[key].item() == 0
        assert key[:-len(COUNT)] + "running_mean" in got
    net.load_state_dict(got, strict=True)
    return net


def test_convert_randlanet_equals_jax_and_logits():
    """The converted weights strict-load into the port's RandLA-Net, whose
    eval net gives the JAX eval net's logits on the JAX converter's
    variables (lattice points: both exact pyramids agree index for
    index)."""
    rng = np.random.default_rng(0)
    sd = _he_scaled(jtc._make_torch_state_dict(rng), rng)
    got = tct.convert_randlanet(sd)
    tree = jct.convert_randlanet(_numpy(sd))
    model = RandLANet(compute_dtype="float32", **RANDLA)
    net = _equal_to_jax(got, tree, model.get_eval_net()).eval()
    coords = lattice_cloud(rng, 1, RANDLA["num_points"])
    feats = rng.uniform(-1, 1, coords.shape).astype(np.float32)
    jnet = JaxRandLANet(compute_dtype="float32", **RANDLA).get_eval_net()
    want = np.asarray(jax.jit(lambda v, b: jnet.apply(v, b, training=False))(
        tree, {"coords": jnp.asarray(coords),
               "features": jnp.asarray(feats)}))
    with torch.no_grad():
        out = net({"coords": torch.from_numpy(coords),
                   "features": torch.from_numpy(feats)}).numpy()
    assert out.shape == (1, RANDLA["num_points"], 19)
    assert np.abs(want).max() > 0
    assert np.abs(out - want).max() <= 1e-5 * np.abs(want).max()


def test_convert_pointpillars_equals_jax_on_the_reference_mirror():
    """test_convert's torch mirror of the reference net (the zoo's widths)
    converts as in JAX and strict-loads into the port's net of those
    widths."""
    sd = PP_MIRROR()._torch_mirror().state_dict()
    got = tct.convert_pointpillars(sd)
    tree = jct.convert_pointpillars(_numpy(sd))
    _equal_to_jax(got, tree, PointPillars(**PP_WIDE).get_net())


def test_convert_pointpillars_logits_equal_jax():
    """``chip_smoke.pp_reference_state_dict`` (the port's weights under the
    reference's names) converts back to those weights; the port's canvas
    and compact nets on them give the JAX nets' head outputs on the JAX
    converter's variables."""
    model = PointPillars(**PP_SMALL)
    drawn = chip_smoke.pp_random_weights(model.get_net())
    sd = chip_smoke.pp_reference_state_dict(drawn)
    got = tct.convert_pointpillars(sd)
    tree = jct.convert_pointpillars(_numpy(sd))
    net = _equal_to_jax(got, tree, model.get_net())
    for key, value in drawn.state_dict().items():
        assert torch.equal(got[key].to(value.dtype), value), key
    rng = np.random.default_rng(3)
    pts = np.zeros((1, 2048, 4), np.float32)
    n = 1500
    for i in range(3):
        lo, hi = PP_SMALL["point_cloud_range"][i::3]
        pts[0, :n, i] = rng.uniform(lo, hi, n)
    pts[0, :n, 3] = rng.uniform(0, 1, n)
    count = np.array([n], np.int32)
    jmodel = JaxPointPillars(**PP_SMALL)
    for port_net, jnet in ((net, jmodel.get_net()),
                           (model.get_eval_net(), jmodel.get_eval_net())):
        port_net.load_state_dict(got, strict=True)
        with torch.no_grad():
            outs = port_net.eval()({"point": torch.from_numpy(pts),
                                    "point_count": torch.from_numpy(count)})
        want = jax.jit(lambda v, b, jnet=jnet: jnet.apply(
            v, b, training=False))(tree, {"point": jnp.asarray(pts),
                                          "point_count": jnp.asarray(count)})
        for o, w in zip(outs, want):
            w = np.asarray(w)
            assert np.abs(w).max() > 0.05
            np.testing.assert_allclose(o.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("deform", [False, True])
def test_convert_kpfcnn_equals_jax(deform):
    """Rigid and deformable blocks; the checkpoint's kernel points replace
    the Lloyd points the port's net draws."""
    arch = list(jtc.TestKPFCNNConversion.ARCH)
    if deform:
        arch = [b.replace("resnetb", "resnetb_deformable")
                if i in (3, 5) else b for i, b in enumerate(arch)]
    sd = jtc.TestKPFCNNConversion()._make_sd(np.random.default_rng(0), arch)
    got = tct.convert_kpfcnn(sd)
    tree = jct.convert_kpfcnn(sd, architecture=arch)
    net = KPFCNN(num_classes=6, lbl_values=list(range(7)),
                 ignored_label_inds=[0], num_points=256,
                 first_features_dim=32, in_features_dim=2,
                 first_subsampling_dl=0.25, in_radius=3.0,
                 neighborhood_limits=[10, 10, 10],
                 architecture=arch).get_net()
    lloyd = net.state_dict()["enc0.KPConv.points"].clone()
    _equal_to_jax(got, tree, net)
    points = sd["encoder_blocks.0.KPConv.kernel_points"]
    np.testing.assert_array_equal(got["enc0.KPConv.points"].numpy(), points)
    assert not np.allclose(lloyd.numpy(), points)
    if deform:
        assert "enc3.KPConv.offset_conv.points" in got


@pytest.mark.parametrize("residual", [False, True])
def test_convert_sparseconvunet_equals_jax(residual):
    """The recursive U at 3 levels, plain and residual blocks; its
    ``MaskedBatchNorm`` layers count no batches."""
    sd = jtc.TestSparseConvUnetConversion()._make_sd(
        np.random.default_rng(0), residual=residual)
    got = tct.convert_sparseconvunet(sd, num_levels=3,
                                     residual_blocks=residual)
    tree = jct.convert_sparseconvunet(sd, num_levels=3,
                                      residual_blocks=residual)
    assert not any(k.endswith(COUNT) for k in got)
    _equal_to_jax(got, tree, SparseConvUnet(
        multiplier=4, num_levels=3, in_channels=3, num_classes=5,
        residual_blocks=residual).get_net())


def test_convert_pointtransformer_equals_jax():
    sd = jtc.TestPointTransformerConversion()._make_sd(
        np.random.default_rng(0))
    got = tct.convert_pointtransformer(sd)
    tree = jct.convert_pointtransformer(sd)
    _equal_to_jax(got, tree, PointTransformer(in_channels=6,
                                              num_classes=13).get_net())


def test_convert_pointrcnn_equals_jax():
    """Both stages' trees, their head strides and the RCNN's biased
    layers; the state_dict shaped by the JAX net's configuration."""
    jnet = JaxPointRCNN(**PRCNN).get_net()
    sd = jtc.TestPointRCNNConversion()._make_sd(np.random.default_rng(0),
                                                jnet)
    got = tct.convert_pointrcnn(sd)
    tree = jct.convert_pointrcnn(sd)
    _equal_to_jax(got, tree, PointRCNN(**PRCNN).get_net())


def test_convert_pvcnn_strict_loads():
    """PVCNN's converter gives the batch counts too: a strict load."""
    from open3d_ml_tpu_torch.models import PVCNN
    from test_torch_pvcnn import _reference_state_dict
    got = tct.convert_pvcnn(_reference_state_dict(np.random.default_rng(1)))
    PVCNN(width_multiplier=0.25).get_net().load_state_dict(got, strict=True)


def _available(convert, tmp_path, name):
    """The converter names ``convert`` lists when ``name`` has none."""
    with pytest.raises(NotImplementedError) as err:
        convert(tmp_path / "ckpt.pth", model_name=name)
    return re.search(r"available: (\[.*\])", str(err.value))[1]


def _jax_dispatch(monkeypatch, name):
    """The name of the JAX converter that ``convert_checkpoint`` calls for
    ``name`` (each converter stood in for by a recorder)."""
    called = []
    monkeypatch.setattr(jct, "load_torch_checkpoint", lambda path: {})
    for fn in ("convert_randlanet", "convert_pointpillars",
               "convert_kpfcnn", "convert_sparseconvunet",
               "convert_pointtransformer", "convert_pvcnn",
               "convert_pointrcnn"):
        monkeypatch.setattr(jct, fn, lambda sd, fn=fn: called.append(fn))
    jct.convert_checkpoint("unused.pth", model_name=name)
    return called[0]


def test_convert_checkpoint_round_trip_and_dispatch(tmp_path, monkeypatch):
    """A ``.pth`` holding ``model_state_dict`` (as the reference's zoo
    files do) converts as its state_dict does; the dispatch table is the
    JAX one, name for name, with no PointRCNN entry in either."""
    model = PointPillars(**PP_SMALL)
    sd = chip_smoke.pp_reference_state_dict(model.get_net())
    torch.save({"model_state_dict": sd, "epoch": 3}, tmp_path / "ckpt.pth")
    got = tct.convert_checkpoint(tmp_path / "ckpt.pth", "PointPillars")
    want = tct.convert_pointpillars(sd)
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    model.get_net().load_state_dict(got, strict=True)
    loaded = tct.load_torch_checkpoint(tmp_path / "ckpt.pth")
    assert set(loaded) == set(sd)
    assert all(isinstance(v, np.ndarray) for v in loaded.values())

    listed = _available(tct.convert_checkpoint, tmp_path, "PointRCNN")
    assert listed == _available(jct.convert_checkpoint, tmp_path,
                                "PointRCNN")
    assert listed == str(sorted(tct.CONVERTERS))
    assert "PointRCNN" not in tct.CONVERTERS
    for name, fn in tct.CONVERTERS.items():
        assert fn.__name__ == _jax_dispatch(monkeypatch, name), name
