"""The port's exact evaluation path against the JAX package: the eval net
(``get_eval_net``), the host side of inference and
``SemanticSegmentation.run_inference``.

The JAX eval net initialises the variables (BN statistics then replaced by
numpy draws so that BN is not the identity); ``load_jax_variables`` puts
them into the port. On lattice coordinates both exact pyramids agree index
for index (``test_torch_knn.py``), so the logits differ only by float32
rounding. ``run_inference`` runs on both sides with the same weights and
the same seeds: the JAX sampler's generator, unseeded in the package, is
set from outside.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open3d_ml_tpu.datasets.augment import SemsegAugmentation as JaxAugment
from open3d_ml_tpu.datasets.samplers import semseg_spatially_regular as jss
from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
from open3d_ml_tpu.ops.subsample import grid_subsampling as jax_grid
from open3d_ml_tpu.pipelines.semantic_segmentation import (
    SemanticSegmentation as JaxPipeline, TrainState)
from open3d_ml_tpu_torch.datasets import InferenceDummySplit
from open3d_ml_tpu_torch.datasets.augment import SemsegAugmentation
from open3d_ml_tpu_torch.datasets.utils import DataProcessing
from open3d_ml_tpu_torch.dataloaders import PointCloudDataloader
from open3d_ml_tpu_torch.models import RandLANet
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.utils import load_jax_variables

from test_torch_ops import lattice_cloud
from test_torch_randlanet import _randomise_stats

REPO = Path(__file__).resolve().parents[1]
B, N = 2, 1024
SMALL = dict(num_points=N, num_layers=4, dim_output=[8, 16, 32, 32])
# run_inference: 3 levels of 256, 64 and 16 points, recentred as the
# shipped config does (the JAX model's default is no augmentation)
TINY = dict(num_points=256, num_layers=3, sub_sampling_ratio=[4, 4, 4],
            dim_output=[8, 16, 16], augment={"recenter": {"dim": [0, 1]}})
MODEL_SEED, SAMPLER_SEED = 3, 4


def _init(net, batch):
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b: net.init({"params": key, "dropout": key},
                                           b, training=False))(batch)
    variables = jax.tree.map(np.asarray, variables)
    return {"params": variables["params"],
            "batch_stats": _randomise_stats(variables["batch_stats"],
                                            np.random.default_rng(1))}


@pytest.fixture(scope="module")
def reference():
    """Inputs, the JAX eval net's variables (numpy) and its logits."""
    rng = np.random.default_rng(0)
    coords = lattice_cloud(rng, B, N)
    feats = rng.uniform(-1, 1, (B, N, 3)).astype(np.float32)
    batch = {"coords": jnp.asarray(coords), "features": jnp.asarray(feats)}
    net = JaxRandLANet(compute_dtype="float32", **SMALL).get_eval_net()
    variables = _init(net, batch)
    logits = np.asarray(jax.jit(
        lambda v, b: net.apply(v, b, training=False))(variables, batch))
    return {"coords": coords, "features": feats, "variables": variables,
            "logits": logits}


def _port_logits(reference, **cfg):
    net = RandLANet(**dict(SMALL, **cfg)).get_eval_net()
    load_jax_variables(net, reference["variables"]).eval()
    with torch.no_grad():
        return net({"coords": torch.from_numpy(reference["coords"]),
                    "features": torch.from_numpy(reference["features"])}
                   ).numpy()


def test_eval_net_variables_load_into_both_nets(reference):
    """The JAX eval net's variables convert with the fused net's converter
    and fill the port's eval net, which has the fused net's keys."""
    model = RandLANet(**SMALL)
    eval_net = load_jax_variables(model.get_eval_net(), reference["variables"])
    assert eval_net.knn_method == "exact"
    assert set(eval_net.state_dict()) == set(model.get_net().state_dict())
    load_jax_variables(model.get_net(), reference["variables"])


def test_eval_net_matches_jax_float32(reference):
    """Same weights, same lattice batch: within 1e-5 of max |logit|."""
    ref = reference["logits"]
    got = _port_logits(reference, compute_dtype="float32")
    assert got.shape == (B, N, 19) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_eval_net_runs_float32_under_bfloat16_config(reference):
    """compute_dtype bfloat16 (the shipped config) leaves the eval net in
    float32: the logits are the float32 net's, bit for bit."""
    np.testing.assert_array_equal(
        _port_logits(reference, compute_dtype="bfloat16"),
        _port_logits(reference, compute_dtype="float32"))


def test_eval_knn_method_selects_the_path():
    assert RandLANet(**SMALL).get_eval_net().knn_method == "exact"
    fused = RandLANet(eval_knn_method="fused", **SMALL).get_eval_net()
    assert fused.knn_method == "fused" and fused.round_bf16
    with pytest.raises(NotImplementedError, match="knn_method"):
        RandLANet(eval_knn_method="approx", **SMALL).get_eval_net()
    with pytest.raises(NotImplementedError, match="knn_on_device"):
        RandLANet(knn_on_device=False, **SMALL).get_eval_net()
    # the fused path's knobs do not bind the exact path
    assert RandLANet(up_mode="search", **SMALL).get_eval_net()


# ------------------------------------------------------------- host pieces

@pytest.mark.parametrize("with_feat", [False, True])
@pytest.mark.parametrize("with_labels", [False, True])
def test_grid_subsampling_bit_equal(with_feat, with_labels):
    rng = np.random.default_rng(5)
    pts = rng.uniform(-3, 3, (5000, 3)).astype(np.float32)
    kw = {}
    if with_feat:
        kw["features"] = rng.uniform(0, 255, (5000, 4)).astype(np.float32)
    if with_labels:
        kw["labels"] = rng.integers(0, 6, 5000).astype(np.int32)
    got = DataProcessing.grid_subsampling(pts, grid_size=0.3, **kw)
    want = jax_grid(pts, grid_size=0.3, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == 1 + with_feat + with_labels
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_augment_recenter_normalize_equal():
    rng = np.random.default_rng(6)
    cfg = {"recenter": {"dim": [0, 1]},
           "normalize": {"points": {"method": "linear"},
                         "feat": {"bias": 3.0, "scale": 2.0}}}
    pc = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    feat = rng.uniform(0, 9, (500, 2)).astype(np.float32)
    got = SemsegAugmentation(cfg).augment(pc.copy(), feat.copy(), None, cfg)
    want = JaxAugment(cfg).augment(pc.copy(), feat.copy(), None, cfg)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    with pytest.raises(NotImplementedError, match="all"):
        SemsegAugmentation({}).augment(pc, feat, None,
                                       {"rotate": {"method": "all"}})


def _cloud(n=1000, seed=7):
    rng = np.random.default_rng(seed)
    return {"point": rng.uniform(-2, 2, (n, 3)).astype(np.float32),
            "feat": None, "label": None}


@pytest.mark.parametrize("n", [600, 200])
def test_sampler_and_transform_draw_the_same_patches(n):
    """Seeded alike, both samplers pick the same centres and both
    transforms return the same patches, over several draws; a cloud
    smaller than a patch is padded with random repeats."""
    data = _cloud(n)
    jmodel = JaxRandLANet(seed=MODEL_SEED, **TINY)
    tmodel = RandLANet(seed=MODEL_SEED, **TINY)
    attr = {"split": "test"}
    jpre, tpre = jmodel.preprocess(data, attr), tmodel.preprocess(data, attr)
    np.testing.assert_array_equal(tpre["proj_inds"], jpre["proj_inds"])

    split = InferenceDummySplit(data, seed=SAMPLER_SEED)
    loader = PointCloudDataloader(split, preprocess=tmodel.preprocess,
                                  transform=tmodel.transform)
    tsampler = split.sampler
    jsampler = jss.SemSegSpatiallyRegularSampler(split)
    jsampler.rng = np.random.default_rng(SAMPLER_SEED)
    tsampler.initialize_with_dataloader(loader)
    jsampler.initialize_with_dataloader(loader)
    tmodel.trans_point_sampler = tsampler.get_point_sampler()
    jmodel.trans_point_sampler = jsampler.get_point_sampler()
    for _ in range(4):
        got = tmodel.transform(tpre, attr)
        want = jmodel.transform(jpre, attr)
        for key in ("coords", "features", "labels", "point_inds"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(tsampler.possibilities[0],
                                      jsampler.possibilities[0])


def test_update_probs_matches_jax():
    rng = np.random.default_rng(8)
    logits = rng.normal(0, 3, (1, 256, 19)).astype(np.float32)
    inds = rng.choice(400, 256, replace=False).astype(np.int32)
    start = rng.random((400, 19)).astype(np.float16)
    inputs = {"point_inds": inds[None]}
    got = RandLANet(**TINY).update_probs(inputs, logits, start.copy())
    want = JaxRandLANet(**TINY).update_probs(inputs, logits, start.copy())
    assert got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), rtol=0, atol=1e-3)


# ---------------------------------------------------------- run_inference

def test_run_inference_matches_jax(tmp_path, monkeypatch):
    """Same cloud, weights and seeds: equal labels, and scores within 1e-3
    (the accumulators are float16)."""
    data = _cloud()
    # no persistent compile cache under HOME for this pipeline
    monkeypatch.setenv("OPEN3D_ML_TPU_COMPILE_CACHE", "0")
    jmodel = JaxRandLANet(seed=MODEL_SEED, **TINY)
    jpipe = JaxPipeline(jmodel, main_log_dir=str(tmp_path), device="cpu")
    coords = jnp.zeros((1, TINY["num_points"], 3), jnp.float32)
    variables = _init(jmodel.get_eval_net(),
                      {"coords": coords, "features": coords})
    jpipe.state = TrainState(params=variables["params"],
                             batch_stats=variables["batch_stats"],
                             opt_state=(), step=jnp.zeros((), jnp.int32))
    init = jss.SemSegSpatiallyRegularSampler.__init__

    def seeded_init(self, dataset):
        init(self, dataset)
        self.rng = np.random.default_rng(SAMPLER_SEED)

    monkeypatch.setattr(jss.SemSegSpatiallyRegularSampler, "__init__",
                        seeded_init)
    want = jpipe.run_inference(data)

    tpipe = SemanticSegmentation(RandLANet(seed=MODEL_SEED, **TINY),
                                 device="cpu", seed=SAMPLER_SEED)
    load_jax_variables(tpipe.net, variables)
    got = tpipe.run_inference(data)
    n = data["point"].shape[0]
    assert got["predict_labels"].shape == (n,)
    assert got["predict_scores"].shape == (n, 19)
    assert np.isfinite(got["predict_scores"]).all()
    np.testing.assert_array_equal(got["predict_labels"],
                                  want["predict_labels"])
    np.testing.assert_allclose(got["predict_scores"].astype(np.float32),
                               want["predict_scores"].astype(np.float32),
                               rtol=0, atol=1e-3)


def test_run_inference_is_seeded():
    """Two pipelines with one seed give the same result; the weights come
    from the pipeline's seed, not from torch's global generator."""
    def run(seed):
        torch.manual_seed(seed)  # must not matter
        pipe = SemanticSegmentation(RandLANet(seed=MODEL_SEED, **TINY),
                                    device="cpu", seed=SAMPLER_SEED)
        return pipe.run_inference(_cloud(500))["predict_scores"]

    np.testing.assert_array_equal(run(0), run(1))


def test_pipeline_imports_no_jax():
    """The port's pipeline and eval net load neither JAX, PyYAML nor the
    JAX package."""
    code = ("import sys\n"
            "from open3d_ml_tpu_torch.models import RandLANet\n"
            "from open3d_ml_tpu_torch.pipelines import SemanticSegmentation\n"
            "m = RandLANet(num_points=256, num_layers=2)\n"
            "SemanticSegmentation(m, device='cpu', seed=0)\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'yaml',\n"
            "                   'open3d_ml_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
