"""The port's RandLA-Net (``open3d_ml_tpu_torch``) against the JAX package.

The JAX ``RandLANet(...).get_net()`` initialises the variables; the BN
statistics are then replaced by numpy draws so that BN is not the identity.
The same variables go into the port (``load_jax_variables``), the same
numpy batch through both nets in inference mode, and the logits are
compared. On the CPU the JAX fused path runs its kernels' XLA twins and the
port its kernels' plain versions.

The config is small but reaches every branch of the shipped config's path:
table compaction, the pool reuse with a 16-query pool block, the pool
search at levels 2 and 3, derived upsample tables, and S clamped by the
level size.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch import MODEL
from open3d_ml_tpu_torch.models import RandLANet
from open3d_ml_tpu_torch.utils import load_jax_variables
from open3d_ml_tpu_torch.utils.convert_jax import jax_to_state_dict

from test_torch_ops import lattice_cloud
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
B, N = 2, 2560
SMALL = dict(num_points=N, num_layers=4, dim_output=[8, 16, 32, 32], seg=32,
             block=64, num_segs=8, gather_segs=4, infer_num_segs=6,
             infer_gather_segs=4, up_mode="derive")


def _randomise_stats(tree, rng):
    return {k: (_randomise_stats(v, rng) if isinstance(v, dict) else
                rng.normal(0.0, 0.2, v.shape).astype(np.float32)
                if k == "mean" else
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def reference():
    """Inputs, JAX variables (numpy) and the JAX logits per compute dtype."""
    rng = np.random.default_rng(0)
    coords = lattice_cloud(rng, B, N)
    feats = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    batch = {"coords": jnp.asarray(coords), "features": jnp.asarray(feats)}
    net = JaxRandLANet(compute_dtype="float32", **SMALL).get_net()
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: net.init({"params": key, "dropout": key},
                                           b, training=False))(batch)
    variables = jax.tree.map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _randomise_stats(variables["batch_stats"],
                                                 rng)}
    logits = {}
    for dtype in ("float32", "bfloat16"):
        jnet = JaxRandLANet(compute_dtype=dtype, **SMALL).get_net()
        logits[dtype] = np.asarray(jax.jit(
            lambda v, b: jnet.apply(v, b, training=False))(variables, batch))
    return {"coords": coords, "features": feats, "variables": variables,
            "logits": logits}


def _port_logits(reference, compute_dtype):
    net = RandLANet(compute_dtype=compute_dtype, **SMALL).get_net()
    load_jax_variables(net, reference["variables"]).eval()
    with torch.no_grad():
        return net({"coords": torch.from_numpy(reference["coords"]),
                    "features": torch.from_numpy(reference["features"])}
                   ).numpy()


def test_load_jax_variables_maps_every_leaf(reference):
    variables = reference["variables"]
    net = load_jax_variables(RandLANet(**SMALL).get_net(), variables)
    sd = net.state_dict()
    n_leaves = sum(len(jax.tree.leaves(variables[c]))
                   for c in ("params", "batch_stats"))
    assert len([k for k in sd if not k.endswith("num_batches_tracked")]) == \
        n_leaves
    params = variables["params"]["net"]
    np.testing.assert_array_equal(
        sd["encoder_1.lse2.mlp.conv.weight"].numpy(),
        params["encoder_1"]["lse2"]["mlp"]["conv"]["kernel"].T)
    np.testing.assert_array_equal(sd["fc1_3.conv.bias"].numpy(),
                                  params["fc1_3"]["conv"]["bias"])
    np.testing.assert_array_equal(sd["bn0.weight"].numpy(),
                                  params["bn0"]["scale"])
    stats = variables["batch_stats"]["net"]["decoder_2"]["batch_norm"]
    np.testing.assert_array_equal(sd["decoder_2.batch_norm.running_var"],
                                  stats["var"])
    np.testing.assert_array_equal(sd["decoder_2.batch_norm.running_mean"],
                                  stats["mean"])
    bn = net.encoder_0.pool1.mlp.batch_norm
    assert bn.eps == 1e-6 and bn.momentum == 0.01


def test_load_jax_variables_rejects_missing_and_unused(reference):
    variables = reference["variables"]
    net = RandLANet(**SMALL).get_net()
    params = dict(variables["params"]["net"])
    del params["fc0"]
    with pytest.raises(KeyError, match="fc0"):
        load_jax_variables(net, {"params": {"net": params},
                                 "batch_stats": variables["batch_stats"]})
    params = dict(variables["params"]["net"], extra={"kernel": np.ones(2)})
    with pytest.raises(KeyError, match="extra"):
        load_jax_variables(net, {"params": {"net": params},
                                 "batch_stats": variables["batch_stats"]})
    assert "bn0.running_mean" in jax_to_state_dict(variables)


def test_slice_matches_jax_float32(reference):
    """Same weights, same batch: every stage is exact or float32 rounding
    apart, so the logits agree to 1e-4 of their largest magnitude."""
    ref = reference["logits"]["float32"]
    got = _port_logits(reference, "float32")
    assert got.shape == (B, N, 19)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_slice_matches_jax_bfloat16(reference):
    """At bfloat16 the port rounds every gathered value to bf16 as the TPU
    kernel did, while the JAX twin run here gathers exact float32. Measured
    on this config: relative L2 0.0042, argmax agreement 0.995; the limits
    leave about twice that room, and a bf16 step in the wrong precision
    (BN, softmax or the head) moves the logits past them."""
    ref = reference["logits"]["bfloat16"]
    got = _port_logits(reference, "bfloat16")
    assert np.isfinite(got).all()
    rel_l2 = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    agree = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert rel_l2 <= 1e-2, rel_l2
    assert agree >= 0.98, agree


def test_eval_selects_inference_budget():
    """train() searches num_segs and gathers gather_segs slots; eval()
    takes infer_num_segs and infer_gather_segs."""
    cfg = dict(SMALL, num_segs=7, gather_segs=5, infer_num_segs=6,
               infer_gather_segs=3)
    net = RandLANet(compute_dtype="float32", **cfg).get_net()
    coords = torch.from_numpy(lattice_cloud(np.random.default_rng(1), 1, N))
    widths = {}
    for training in (True, False):
        net.train(training)
        levels, _ = net._levels(coords)
        widths[training] = [levels[i].tables[name][0].shape[-1]
                            for i, name in ((0, "nbr"), (2, "pool"))]
    # level 2 holds 160 points, 5 segments: its pool search keeps all 5
    assert widths == {True: [5, 5], False: [3, 5]}


def test_defaults_equal_shipped_yaml():
    cfg = Config.load_from_file(
        REPO / "open3d_ml_tpu/configs/randlanet_semantickitti.yml")
    defaults = RandLANet().cfg.to_dict()
    for key, value in cfg.model.to_dict().items():
        assert defaults[key] == value, key


def test_chip_smoke_training_config_equals_shipped_yaml():
    """``chip_smoke.py`` trains with the shipped config's class weights
    and pipeline settings without reading the YAML."""
    import chip_smoke
    cfg = Config.load_from_file(
        REPO / "open3d_ml_tpu/configs/randlanet_semantickitti.yml")
    assert chip_smoke.SEMANTICKITTI_CLASS_WEIGHTS == list(
        cfg.dataset.class_weights)
    for key, value in chip_smoke.TRAIN_PIPELINE.items():
        assert cfg.pipeline[key] == value, key


def test_registry_is_the_ports_own():
    import open3d_ml_tpu.utils as jax_utils
    assert MODEL.get("RandLANet") is RandLANet
    assert MODEL is not jax_utils.MODEL
    assert jax_utils.MODEL.get("RandLANet") is not RandLANet


@pytest.mark.parametrize("key, value", [("knn_method", "approx"),
                                        ("up_mode", "search"),
                                        ("gather_qblock", 32)])
def test_get_net_rejects_unported_paths(key, value):
    with pytest.raises(NotImplementedError, match=key):
        RandLANet(**{key: value}).get_net()


def test_port_imports_no_jax():
    """Neither the port nor ``chip_smoke.py`` loads JAX or the JAX
    package; nor, until a file is read, ``joblib`` or ``pandas`` (the
    card's machine has no ``joblib``)."""
    code = ("import sys\n"
            "import open3d_ml_tpu_torch\n"
            "import open3d_ml_tpu_torch.models.randlanet\n"
            "import open3d_ml_tpu_torch.ops.bucket\n"
            "import open3d_ml_tpu_torch.ops.neighbors\n"
            "import open3d_ml_tpu_torch.pipelines\n"
            "import open3d_ml_tpu_torch.modules\n"
            "import open3d_ml_tpu_torch.modules.losses\n"
            "import open3d_ml_tpu_torch.modules.metrics\n"
            "import open3d_ml_tpu_torch.modules.schedulers\n"
            "import open3d_ml_tpu_torch.datasets.synthetic\n"
            "import open3d_ml_tpu_torch.dataloaders.batch_loader\n"
            "import open3d_ml_tpu_torch.ops.cuda._build\n"
            "import open3d_ml_tpu_torch.utils.convert_jax\n"
            "import open3d_ml_tpu_torch.utils.builder\n"
            "import open3d_ml_tpu_torch.utils.config\n"
            "import open3d_ml_tpu_torch.run_pipeline\n"
            "import open3d_ml_tpu_torch.datasets.semantickitti\n"
            "import open3d_ml_tpu_torch.datasets.scannet\n"
            "import open3d_ml_tpu_torch.datasets.s3dis\n"
            "import open3d_ml_tpu_torch.datasets.semantic3d\n"
            "import open3d_ml_tpu_torch.datasets.toronto3d\n"
            "import open3d_ml_tpu_torch.datasets.parislille3d\n"
            "import open3d_ml_tpu_torch.datasets.utils.ply\n"
            "import open3d_ml_tpu_torch.models.point_transformer\n"
            "import open3d_ml_tpu_torch.ops.sampling\n"
            "import open3d_ml_tpu_torch.ops.interpolation\n"
            "import open3d_ml_tpu_torch.ops.cuda.sampling\n"
            "import open3d_ml_tpu_torch.models.kpconv\n"
            "import open3d_ml_tpu_torch.models.pointnet2\n"
            "import open3d_ml_tpu_torch.models.point_rcnn\n"
            "import open3d_ml_tpu_torch.ops.cuda.nms\n"
            "import open3d_ml_tpu_torch.ops.nms\n"
            "import open3d_ml_tpu_torch.native\n"
            "import open3d_ml_tpu_torch.models.pvcnn\n"
            "import open3d_ml_tpu_torch.ops.cuda.devoxelize\n"
            "import open3d_ml_tpu_torch.utils.convert_torch\n"
            "import open3d_ml_tpu_torch.datasets.pandaset\n"
            "import open3d_ml_tpu_torch.datasets.shapenet\n"
            "import open3d_ml_tpu_torch.datasets.sunrgbd\n"
            "import open3d_ml_tpu_torch.datasets.matterport_objects\n"
            "import open3d_ml_tpu_torch.datasets.tumfacade\n"
            "import open3d_ml_tpu_torch.datasets.utils.pcd\n"
            "import open3d_ml_tpu_torch.datasets.utils.transforms\n"
            "import open3d_ml_tpu_torch.ops.ragged\n"
            "import open3d_ml_tpu_torch.ops.subsample\n"
            "import open3d_ml_tpu_torch.modules.optimizers\n"
            "import open3d_ml_tpu_torch.vis.boundingbox\n"
            "import open3d_ml_tpu_torch.pipelines.summaries\n"
            "import open3d_ml_tpu_torch.utils.flops\n"
            "import open3d_ml_tpu_torch.utils.profiling\n"
            "import open3d_ml_tpu_torch.parallel\n"
            "import open3d_ml_tpu_torch.parallel.mesh\n"
            "import open3d_ml_tpu_torch.parallel.dryrun\n"
            "import chip_smoke\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'yaml', 'joblib',\n"
            "                   'pandas', 'open3d_ml_tpu')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_off_the_card(where, tmp_path):
    """With no CUDA device, or with none of the repo beside it, the script
    exits non-zero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert ("no CUDA device" if where == "repo" else
            "open3d_ml_tpu_torch") in run.stderr
    assert '"ok"' not in run.stdout
