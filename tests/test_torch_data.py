"""The port's training data path and ``run_train`` on the CPU.

The host side against the JAX package, seeded alike: the procedural
scenes (``SyntheticShapes``), the random sampler's cloud order and
patches, the training augmentations and the training transform are
bit-equal. Then the loaders (the preprocess cache, the epoch length, the
prefetching ``BatchLoader``) and ``SemanticSegmentation.run_train`` end to
end: two steps, a checkpoint, a resume into a fresh pipeline, and
``run_test`` over every test cloud.
"""

import threading

import numpy as np
import pytest
import torch

from open3d_ml_tpu.datasets.augment import SemsegAugmentation as JaxAugment
from open3d_ml_tpu.datasets.samplers import semseg_random as jsr
from open3d_ml_tpu.datasets.synthetic import SyntheticShapes as JaxShapes
from open3d_ml_tpu.datasets.synthetic import make_semseg_scene as jax_scene
from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
from open3d_ml_tpu_torch.dataloaders import (BatchLoader, DefaultBatcher,
                                             PointCloudDataloader)
from open3d_ml_tpu_torch.datasets import SyntheticShapes, make_semseg_scene
from open3d_ml_tpu_torch.datasets.augment import SemsegAugmentation
from open3d_ml_tpu_torch.datasets.samplers import SemSegRandomSampler
from open3d_ml_tpu_torch.models import RandLANet
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.utils import Cache

from test_torch_randlanet import SMALL
from torch_threads import one_torch_thread  # noqa: F401

AUGMENT = {"recenter": {"dim": [0, 1]}, "rotate": {"method": "vertical"},
           "scale": {"min_s": 0.9, "max_s": 1.1},
           "noise": {"noise_std": 0.01}}
# 3 levels of 256, 64 and 16 points
TINY = dict(num_points=256, num_layers=3, sub_sampling_ratio=[4, 4, 4],
            dim_output=[8, 16, 16], seg=32, block=64, num_segs=4,
            gather_segs=2, infer_num_segs=3, infer_gather_segs=2,
            grid_size=0.06)


@pytest.mark.parametrize("seed", [0, 5])
def test_semseg_scene_bit_equal(seed):
    got = make_semseg_scene(6000, seed)
    want = jax_scene(6000, seed)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_synthetic_shapes_splits_equal():
    kw = dict(num_points_per_cloud=3000, seed=2,
              num_clouds={"training": 3, "validation": 2, "test": 1})
    port, ref = SyntheticShapes(**kw), JaxShapes(**kw)
    assert port.get_label_to_names() == ref.get_label_to_names()
    for split in ("train", "validation", "test"):
        ps, rs = port.get_split(split), ref.get_split(split)
        assert len(ps) == len(rs)
        for i in range(len(ps)):
            assert ps.get_attr(i) == rs.get_attr(i)
            for key in ("point", "feat", "label"):
                np.testing.assert_array_equal(ps.get_data(i)[key],
                                              rs.get_data(i)[key])
    assert type(port.get_split("train").sampler).__name__ == \
        "SemSegRandomSampler"
    assert type(port.get_split("test").sampler).__name__ == \
        "SemSegSpatiallyRegularSampler"


def test_random_sampler_order_and_patches_equal():
    """Seeded alike, both samplers visit the clouds in the same order and
    draw the same patches, padded with random repeats when a cloud is
    smaller than a patch."""
    from scipy.spatial import cKDTree
    split = SyntheticShapes(num_points_per_cloud=2000, seed=0,
                            num_clouds={"training": 5}).get_split("train")
    port = SemSegRandomSampler(split, seed=9)
    ref = jsr.SemSegRandomSampler(split)
    ref.rng = np.random.default_rng(9)
    assert list(port.get_cloud_sampler()) == list(ref.get_cloud_sampler())
    pc = split.get_data(0)["point"]
    tree = cKDTree(pc)
    draw_p, draw_r = port.get_point_sampler(), ref.get_point_sampler()
    rng_p, rng_r = np.random.default_rng(4), np.random.default_rng(4)
    for n in (500, 2500):
        got = draw_p(pc=pc, num_points=n, search_tree=tree, rng=rng_p)
        want = draw_r(pc=pc, num_points=n, search_tree=tree, rng=rng_r)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_training_augmentations_equal():
    rng = np.random.default_rng(23)
    pc = rng.uniform(-20, 20, (700, 3)).astype(np.float32)
    got = SemsegAugmentation(AUGMENT, seed=6).augment(pc.copy(), None, None,
                                                      AUGMENT)
    want = JaxAugment(AUGMENT, seed=6).augment(pc.copy(), None, None,
                                               AUGMENT)
    assert got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])
    aniso = {"scale": {"min_s": 0.5, "max_s": 2.0, "scale_anisotropic": True}}
    gen_p, gen_j = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):  # the generator passed as the seed drives both
        np.testing.assert_array_equal(
            SemsegAugmentation(aniso).augment(pc, None, None, aniso,
                                              seed=gen_p)[0],
            JaxAugment(aniso).augment(pc, None, None, aniso, seed=gen_j)[0])
    hue = {"HueSaturationTranslation": {}}  # ported with PointTransformer
    colours = rng.uniform(0, 255, (700, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        SemsegAugmentation(hue, seed=8).augment(pc, colours.copy(), None,
                                                hue)[1],
        JaxAugment(hue, seed=8).augment(pc, colours.copy(), None, hue)[1])
    every = {"rotate": {"method": "all"}}
    np.testing.assert_array_equal(
        SemsegAugmentation(every, seed=9).augment(pc.copy(), None, None,
                                                  every)[0],
        JaxAugment(every, seed=9).augment(pc.copy(), None, None, every)[0])


def test_training_transform_equal():
    """The training split's transform, patch and augmentation, over
    several draws from models seeded alike."""
    split = SyntheticShapes(num_points_per_cloud=3000, seed=1,
                            num_clouds={"training": 2}).get_split("train")
    jmodel = JaxRandLANet(seed=3, augment=AUGMENT, **TINY)
    tmodel = RandLANet(seed=3, augment=AUGMENT, **TINY)
    attr = split.get_attr(1)
    data = split.get_data(1)
    jpre, tpre = jmodel.preprocess(data, attr), tmodel.preprocess(data, attr)
    jmodel.trans_point_sampler = jsr.SemSegRandomSampler.get_point_sampler()
    tmodel.trans_point_sampler = SemSegRandomSampler.get_point_sampler()
    for _ in range(3):
        got = tmodel.transform(tpre, attr)
        want = jmodel.transform(jpre, attr)
        for key in ("coords", "features", "labels", "point_inds"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ------------------------------------------------------------------ loaders

def test_cache_computes_once(tmp_path):
    calls = []

    def work(x):
        calls.append(x)
        return {"x": np.arange(x), "tree": {"nested": x}}

    cache = Cache(work, cache_dir=str(tmp_path), cache_key=7)
    first = cache("a", 3)
    again = Cache(work, cache_dir=str(tmp_path), cache_key=7)("a")
    assert calls == [3]
    np.testing.assert_array_equal(first["x"], again["x"])
    assert again["tree"] == {"nested": 3}


def test_dataloader_cache_and_epoch_length(tmp_path):
    dataset = SyntheticShapes(num_points_per_cloud=2000, seed=0,
                              num_clouds={"training": 3},
                              cache_dir=str(tmp_path))
    split = dataset.get_split("train")
    model = RandLANet(**TINY)
    seen = []

    def preprocess(data, attr):
        seen.append(attr["name"])
        return model.preprocess(data, attr)

    loader = PointCloudDataloader(split, preprocess=preprocess,
                                  use_cache=True, steps_per_epoch=7)
    assert sorted(seen) == ["training_0000", "training_0001",
                            "training_0002"]
    assert len(loader) == 7
    item = loader[4]  # wraps to cloud 1, read from the cache
    assert item["attr"]["name"] == "training_0001" and len(seen) == 3
    np.testing.assert_array_equal(
        item["data"]["point"],
        model.preprocess(split.get_data(1), split.get_attr(1))["point"])
    assert PointCloudDataloader(split).cache_convert is None


class _Items:
    """A dataloader stand-in whose items are their indices."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise KeyError(f"item {i}")
        return {"i": np.array([i])}


@pytest.mark.parametrize("workers", [0, 1, 3])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_loader_order_and_drop_last(workers, drop_last):
    loader = BatchLoader(_Items(10), 4, DefaultBatcher(), num_workers=workers,
                         drop_last=drop_last)
    batches = [b["i"][:, 0].tolist() for b in loader]
    want = [[0, 1, 2, 3], [4, 5, 6, 7]] + ([] if drop_last else [[8, 9]])
    assert batches == want
    assert len(loader) == len(want)


def test_batch_loader_follows_the_sampler_and_stops_cleanly():
    class Order:
        def get_cloud_sampler(self):
            return iter([5, 3, 1, 0, 2, 4, 6])

    loader = BatchLoader(_Items(6), 2, DefaultBatcher(), num_workers=2,
                         sampler=Order())
    assert [b["i"][:, 0].tolist() for b in loader] == [[5, 3], [1, 0],
                                                       [2, 4]]
    before = threading.active_count()
    it = iter(BatchLoader(_Items(100), 2, DefaultBatcher(), num_workers=2,
                          prefetch=1))
    next(it)
    it.close()  # the worker stops instead of waiting on a full queue
    assert threading.active_count() == before
    with pytest.raises(KeyError, match="item 5"):
        list(BatchLoader(_Items(8, fail_at=5), 2, DefaultBatcher(),
                         num_workers=2))


# ---------------------------------------------------------------- run_train

def _pipeline(tmp_path, seed, max_epoch):
    dataset = SyntheticShapes(
        num_points_per_cloud=3000, seed=0,
        num_clouds={"training": 3, "validation": 2, "test": 2},
        use_cache=True, cache_dir=str(tmp_path / "cache"),
        test_result_folder=str(tmp_path / "results"),
        steps_per_epoch_train=4, steps_per_epoch_valid=2,
        class_weights=list(range(1, 20)))
    model = RandLANet(seed=seed, augment=AUGMENT,
                      **dict(SMALL, num_points=512))
    return SemanticSegmentation(
        model, dataset=dataset, device="cpu", seed=seed, max_epoch=max_epoch,
        batch_size=2, val_batch_size=2, test_batch_size=2, num_workers=1,
        optimizer={"lr": 1e-3}, scheduler_gamma=0.9,
        main_log_dir=str(tmp_path / "logs"))


def test_run_train_checkpoint_resume_and_test(tmp_path):
    """Two steps and a validation step with finite losses; a checkpoint; a
    fresh pipeline (other initial weights) resumes from it at epoch 1 with
    the saved weights and Adam state; ``run_test`` labels every point of
    every test cloud and saves each."""
    first = _pipeline(tmp_path, seed=0, max_epoch=0)
    first.run_train()
    assert len(first.losses) == 2 and len(first.valid_losses) == 1
    assert np.isfinite(first.losses + first.valid_losses).all()
    assert first.scheduler.last_epoch == 2
    ckpt = tmp_path / "logs" / "RandLANet_SyntheticShapes_torch" / \
        "checkpoint" / "ckpt_00000.pth"
    assert ckpt.exists()
    saved_net = {k: v.clone() for k, v in first.net.state_dict().items()}
    saved_opt = first.optimizer.state_dict()

    resumed = _pipeline(tmp_path, seed=1, max_epoch=1)
    assert not torch.equal(resumed.net.fc0.weight, saved_net["fc0.weight"])
    resumed.optimizer, resumed.scheduler = resumed.model.get_optimizer(
        resumed.cfg, resumed.net)
    assert resumed.load_ckpt() == 1
    for key, value in resumed.net.state_dict().items():
        assert torch.equal(value, saved_net[key]), key
    state = resumed.optimizer.state_dict()["state"]
    for idx, moments in saved_opt["state"].items():
        for name, value in moments.items():
            assert torch.equal(state[idx][name], value), (idx, name)
    assert resumed.scheduler.last_epoch == 2

    resumed.run_train()  # epoch 1 only
    assert len(resumed.losses) == 2
    assert resumed.scheduler.last_epoch == 4
    assert (ckpt.parent / "ckpt_00001.pth").exists()

    results = resumed.run_test()
    test_split = resumed.dataset.get_split("test")
    assert sorted(results) == list(range(len(test_split)))
    for cid, res in results.items():
        n = test_split.get_data(cid)["point"].shape[0]
        assert res["predict_labels"].shape == (n,)
        assert np.isfinite(res["predict_scores"].astype(np.float32)).all()
        assert (tmp_path / "results" /
                f"{test_split.get_attr(cid)['name']}.npy").exists()
    # the eval net ran with the trained weights
    for key, value in resumed.eval_net.state_dict().items():
        assert torch.equal(value, resumed.net.state_dict()[key]), key


def test_run_train_is_seeded(tmp_path):
    """Two runs with the same seeds train the same weights: the initial
    weights and the dropout come from the pipeline's seed, the cloud order
    from the dataset's, the patches and their augmentation from the
    model's."""
    def run(sub):
        pipe = _pipeline(tmp_path / sub, seed=4, max_epoch=0)
        torch.manual_seed(int(sub[-1]))  # must not matter
        pipe.run_train()
        return pipe.losses, pipe.net.state_dict()

    (l1, s1), (l2, s2) = run("a1"), run("b2")
    assert l1 == l2
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key
