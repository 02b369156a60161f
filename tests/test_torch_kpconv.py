"""The port's KPConv (KPFCNN, ``open3d_ml_tpu_torch``) against the JAX
package: the KD-tree, the samplers' ball patches, the host pyramid, the
kernel points, ``KPConvOp`` and the net.

Inputs are made with numpy from a seed and go through both packages. The
host side is compared bit for bit: both KD-trees are the same C++, so a
radius query's neighbours come in the same order, which decides what is
kept where a query has more than the level's limit. The net runs at the
JAX tests' small config (512 points, width 32, 3 levels, B = 2) on the
JAX net's variables (BN statistics drawn), carried over with
``load_jax_variables``; float32 logits within 1e-5 relative L2 (``TOL``).
The training step, the optimizer and the command line are in
``test_torch_kpconv_train.py``.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree
from sklearn.neighbors import KDTree

import jax
import jax.numpy as jnp

from open3d_ml_tpu.dataloaders import DefaultBatcher as JaxBatcher
from open3d_ml_tpu.datasets.samplers import (
    SemSegRandomSampler as JaxRandom,
    SemSegSpatiallyRegularSampler as JaxRegular)
from open3d_ml_tpu.models import KPFCNN as JaxKPFCNN
from open3d_ml_tpu.models import kpconv as jkp
from open3d_ml_tpu.native import NativeKDTree as JaxTree
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch import native
from open3d_ml_tpu_torch.dataloaders import DefaultBatcher
from open3d_ml_tpu_torch.datasets.samplers import (
    SemSegRandomSampler, SemSegSpatiallyRegularSampler)
from open3d_ml_tpu_torch.models import KPFCNN
from open3d_ml_tpu_torch.models import kpconv as tkp
from open3d_ml_tpu_torch.native import NativeKDTree
from open3d_ml_tpu_torch.utils import load_jax_variables, state_dict_to_jax
from open3d_ml_tpu_torch.utils.convert_jax import jax_to_state_dict

from test_torch_randlanet import REPO, _randomise_stats

TOL = 1e-5  # float32 relative L2
B = 2
SMALL_ARCH = ["simple", "resnetb", "resnetb_strided", "resnetb",
              "resnetb_strided", "resnetb", "nearest_upsample", "unary",
              "nearest_upsample", "unary"]
# the JAX tests' small config (tests/test_kpconv.py), with the shipped
# YAMLs' batch-norm momentum and augmentations
AUGMENT = {"rotate": {"method": "vertical"},
           "scale": {"min_s": 0.8, "max_s": 1.2},
           "noise": {"noise_std": 0.001}}
SMALL = dict(num_classes=6, lbl_values=list(range(7)),
             ignored_label_inds=[0], num_points=512, first_features_dim=32,
             in_features_dim=2, first_subsampling_dl=0.2, in_radius=3.0,
             neighborhood_limits=[12, 12, 12], batch_norm_momentum=0.98,
             architecture=SMALL_ARCH, augment=AUGMENT)
YAMLS = ("semantickitti", "s3dis", "semantic3d", "toronto3d",
         "parislille3d")


def warm_cpu_kernels():
    """Run PyTorch's vectorised sqrt, exp and log once over a large
    tensor. With the CPU build of torch 2.13 the first such call of a
    process is sometimes inexact on part of its tensor (in some processes,
    with the KD-tree's OpenMP loaded or not); every later call is exact.
    The comparisons with JAX run after this."""
    x = torch.rand(1 << 18) + 0.1
    for fn in (torch.sqrt, torch.exp, torch.log):
        fn(x)
    torch.log_softmax(x.view(-1, 8), -1)


@pytest.fixture(scope="module", autouse=True)
def _warm():
    warm_cpu_kernels()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _cloud(seed, n=4000, extent=8.0, feat=False):
    rng = np.random.default_rng(seed)
    return {"point": rng.uniform(0, extent, (n, 3)).astype(np.float32),
            "feat": (rng.integers(0, 256, (n, 3)).astype(np.float32)
                     if feat else None),
            "label": rng.integers(0, 7, n).astype(np.int32)}


def _assert_equal_samples(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if isinstance(value, list):
            assert len(got[key]) == len(value), key
            for g, w in zip(got[key], value):
                assert g.dtype == w.dtype, key
                np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert got[key].dtype == value.dtype, key
            np.testing.assert_array_equal(got[key], value, err_msg=key)


# ------------------------------------------------------------ the KD-tree

@pytest.mark.parametrize("n, radius, cap", [(4000, 0.5, 16), (20000, 0.3, 37),
                                            (3000, 1.2, 12), (50, 5.0, 64)])
def test_kdtree_radius_rows_equal_jax(n, radius, cap):
    """The padded radius query, row for row, at shapes where the cap
    binds (most rows have more neighbours than ``cap``) and where it does
    not; the counts are not capped; the fill is the sentinel."""
    rng = np.random.default_rng(n)
    pts = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    queries = np.concatenate([pts[::3], np.full((5, 3), 1e6, np.float32)])
    got_i, got_c = NativeKDTree(pts).query_radius_padded(queries, radius,
                                                         cap, fill=n)
    want_i, want_c = JaxTree(pts).query_radius_padded(queries, radius, cap,
                                                      fill=n)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_c, want_c)
    assert (got_c[-5:] == 0).all() and (got_i[-5:] == n).all()
    if n > 1000:
        assert (got_c > cap).mean() > 0.3
    default_i, _ = NativeKDTree(pts).query_radius_padded(queries, radius, cap)
    np.testing.assert_array_equal(default_i, got_i)


@pytest.mark.parametrize("k", [1, 8, 40])
def test_kdtree_knn_equals_jax(k):
    rng = np.random.default_rng(k)
    pts = rng.uniform(-5, 5, (30, 3) if k == 40 else (3000, 3))
    queries = rng.uniform(-5, 5, (500, 3))
    got_d, got_i = NativeKDTree(pts).query(queries, k)
    want_d, want_i = JaxTree(pts).query(queries, k)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


def test_kdtree_library_is_built_in_the_port(tmp_path, monkeypatch):
    """The library comes from the port's own source and build directory,
    and a source that does not compile raises: there is no fallback."""
    path = native.build()
    assert path.parent == REPO / "open3d_ml_tpu_torch" / "csrc" / "build"
    assert native.SRC == REPO / "open3d_ml_tpu_torch" / "native" / \
        "nanoknn.cpp"
    bad = tmp_path / "nanoknn.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*"))


# ------------------------------------------------------------- samplers

class _Split:
    """A split of clouds, for the samplers."""

    def __init__(self, clouds, split):
        self.clouds, self.split = clouds, split

    def __len__(self):
        return len(self.clouds)

    def get_data(self, idx):
        return self.clouds[idx]

    def get_attr(self, idx):
        return {"idx": idx, "name": f"c{idx}", "split": self.split}


class _Loader:
    cache_convert = None

    def __init__(self, n, preprocess=None):
        self.n, self.preprocess = n, preprocess

    def __len__(self):
        return self.n


def _samplers(split, seed=9, length=None, preprocess=None):
    """The port's and the JAX spatially regular samplers, seeded alike and
    initialised over ``split`` (through ``preprocess`` where given)."""
    port = SemSegSpatiallyRegularSampler(split, seed=seed)
    ref = JaxRegular(split)
    ref.rng = np.random.default_rng(seed)
    for s in (port, ref):
        s.initialize_with_dataloader(_Loader(length or len(split),
                                             preprocess))
    return port, ref


@pytest.mark.parametrize("tree", ["scipy", "sklearn"])
def test_ball_patches_and_possibilities_equal_jax(tree):
    """Ball patches (``radius``) from both tree APIs: the patches, indices,
    centres and possibility maps equal the JAX sampler's, draw after draw,
    until the test loop has covered the cloud."""
    pc = _cloud(1, n=3000, extent=4.0)["point"]
    split = _Split([{"point": pc}], "test")
    port, ref = _samplers(split)
    search = cKDTree(pc) if tree == "scipy" else KDTree(pc)
    draw_p, draw_r = port.get_point_sampler(), ref.get_point_sampler()
    rng_p, rng_r = np.random.default_rng(4), np.random.default_rng(4)
    gen_p, gen_r = port.get_cloud_sampler(), ref.get_cloud_sampler()
    sizes = []
    for cid_p, cid_r in zip(gen_p, gen_r):
        assert cid_p == cid_r
        got = draw_p(pc=pc, num_points=100, radius=1.0, search_tree=search,
                     rng=rng_p)
        want = draw_r(pc=pc, num_points=100, radius=1.0, search_tree=search,
                      rng=rng_r)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(port.possibilities[0],
                                      ref.possibilities[0])
        # a ball, not the 100 nearest
        assert np.linalg.norm(got[0] - got[2], axis=1).max() <= 1.0
        sizes.append(len(got[1]))
    assert port.min_possibilities[0] > 0.5 and len(sizes) > 3
    assert max(sizes) > 100 and min(sizes) < 100


def test_isolated_centre_retries_like_jax():
    """A centre alone in its ball gains 0.001 and the next least covered
    point is tried, in both packages."""
    rng = np.random.default_rng(2)
    pc = np.concatenate([rng.uniform(0, 1, (200, 3)),
                         [[50.0, 50.0, 50.0]]]).astype(np.float32)
    split = _Split([{"point": pc}], "test")
    port, ref = _samplers(split)
    for s in (port, ref):
        s.possibilities[0][200] = -1.0
    tree = cKDTree(pc)
    got = port.get_point_sampler()(pc=pc, radius=0.3, search_tree=tree,
                                   rng=np.random.default_rng(0))
    want = ref.get_point_sampler()(pc=pc, radius=0.3, search_tree=tree,
                                   rng=np.random.default_rng(0))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port.possibilities[0],
                                  ref.possibilities[0])
    # raised by 0.001 a try until another point was the least covered
    assert 0 < port.possibilities[0][200] <= 0.002
    assert 200 not in got[1]


def test_spatially_regular_contracts_equal_jax():
    """``patchwise=False`` covers the cloud and returns None; without pc,
    or without both a tree and a radius, both raise KeyError; the
    num_points patches (no radius) equal JAX's, padded where the cloud is
    small."""
    pc = _cloud(3, n=300)["point"]
    split = _Split([{"point": pc}, {"point": pc[:100]}], "test")
    port, ref = _samplers(split)
    for s in (port, ref):
        with pytest.raises(KeyError):
            s.get_point_sampler()(pc=None, radius=1.0)
        with pytest.raises(KeyError):
            s.get_point_sampler()(pc=pc, num_points=10)
    for s in (port, ref):
        s.cloud_id = 1
    for n in (50, 150):
        got = port.get_point_sampler()(pc=pc[:100], num_points=n,
                                       search_tree=cKDTree(pc[:100]),
                                       rng=np.random.default_rng(n))
        want = ref.get_point_sampler()(pc=pc[:100], num_points=n,
                                       search_tree=cKDTree(pc[:100]),
                                       rng=np.random.default_rng(n))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for s in (port, ref):
        s.cloud_id = 0
        assert s.get_point_sampler()(patchwise=False) is None
        assert s.min_possibilities[0] == 1.0
        assert (s.possibilities[0] == 1.0).all()


@pytest.mark.parametrize("split", ["train", "validation", "test"])
def test_cloud_order_equals_jax(split):
    """A training or validation split draws ``length`` times the cloud of
    the lowest least possibility (``gen_train``); a test split visits each
    cloud until it is covered."""
    clouds = [{"point": _cloud(s, n=400)["point"]} for s in range(3)]
    port, ref = _samplers(_Split(clouds, split),
                          length=3 if split == "test" else 7)
    if split == "test":
        for s in (port, ref):
            s.min_possibilities[0] = 0.9
    got, want = [], []
    for gen, s, out in ((port.get_cloud_sampler(), port, got),
                        (ref.get_cloud_sampler(), ref, want)):
        for cid in gen:
            out.append(cid)
            s.min_possibilities[cid] += 0.3
    assert got == want
    assert len(got) == (7 if split != "test" else 4)


def test_random_sampler_ignores_radius():
    """The random sampler takes ``num_points``-nearest patches whatever
    ``radius`` says, in both packages: KPConv trains on them."""
    pc = _cloud(5, n=2000)["point"]
    tree = cKDTree(pc)
    with_r = SemSegRandomSampler.get_point_sampler()(
        pc=pc, num_points=300, radius=0.5, search_tree=tree,
        rng=np.random.default_rng(1))
    without = SemSegRandomSampler.get_point_sampler()(
        pc=pc, num_points=300, search_tree=tree,
        rng=np.random.default_rng(1))
    want = JaxRandom.get_point_sampler()(
        pc=pc, num_points=300, radius=0.5, search_tree=tree,
        rng=np.random.default_rng(1))
    for a, b, c in zip(with_r, without, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert len(with_r[1]) == 300


def test_batcher_collates_levels_like_jax():
    """Per-level lists collate level by level; lists of other things, or
    of differing lengths, stay one entry per sample."""
    rng = np.random.default_rng(0)
    samples = [{"data": {"points": [rng.random((4, 3)), rng.random((2, 3))],
                         "x": rng.random(5), "boxes": ["a"] * (i + 1)}}
               for i in range(3)]
    got = DefaultBatcher().collate_fn(samples)["data"]
    want = JaxBatcher().collate_fn(samples)["data"]
    assert [g.shape for g in got["points"]] == [(3, 4, 3), (3, 2, 3)]
    for g, w in zip(got["points"], want["points"]):
        np.testing.assert_array_equal(g, w)
    assert got["boxes"] == want["boxes"] == [["a"], ["a", "a"],
                                             ["a", "a", "a"]]


# ------------------------------------------------------ host pyramid

@pytest.mark.parametrize("radius, num_points, fixed", [
    (0.15, 15, "center"), (0.3, 15, "verticals"), (1.0, 7, "none"),
    (0.06 * 2.5, 15, "center")])
def test_kernel_point_lloyd_bit_equal(radius, num_points, fixed):
    got = tkp.kernel_point_lloyd.__wrapped__(radius, num_points,
                                             fixed=fixed)
    want = jkp.kernel_point_lloyd.__wrapped__(radius, num_points,
                                              fixed=fixed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _models(**overrides):
    cfg = dict(SMALL, **overrides)
    return KPFCNN(**cfg), JaxKPFCNN(**cfg)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("case", ["lidar", "rgb"])
def test_transform_pyramid_bit_equal(split, case):
    """``preprocess`` and ``transform``: every array of the pyramid, the
    features, labels, ``point_inds`` and ``point_mask`` equal the JAX
    model's, bit for bit, for two draws. Train: random 512-nearest
    patches augmented from the draw's generator. Test: ball patches of
    the spatially regular sampler. ``rgb``: colour features at the S3DIS
    YAML's ``in_features_dim`` 5, which gives 4 columns; its balls hold
    fewer points than the cap, so the padding shows (``point_inds`` -1,
    ``point_mask`` False)."""
    rgb = case == "rgb"
    tm, jm = _models(**(dict(in_features_dim=5, in_radius=1.5) if rgb
                        else {}))
    data = _cloud(7, n=6000, extent=4.0 if rgb else 8.0, feat=rgb)
    attr = {"split": split}
    tpre, jpre = tm.preprocess(data, attr), jm.preprocess(data, attr)
    for key in ("point", "label") + (("feat",) if rgb else ()):
        np.testing.assert_array_equal(tpre[key], jpre[key])
    if split == "test":
        np.testing.assert_array_equal(tpre["proj_inds"], jpre["proj_inds"])
        port, ref = _samplers(_Split([data], "test"),
                              preprocess=tm.preprocess)
        tm.trans_point_sampler = port.get_point_sampler()
        jm.trans_point_sampler = ref.get_point_sampler()
    else:
        assert "proj_inds" not in tpre
        tm.trans_point_sampler = SemSegRandomSampler.get_point_sampler()
        jm.trans_point_sampler = JaxRandom.get_point_sampler()
    for seed in (1, 2):
        got = tm.transform(tpre, attr, rng=np.random.default_rng(seed))
        want = jm.transform(jpre, attr, rng=np.random.default_rng(seed))
        _assert_equal_samples(got, want)
        assert got["features"].shape == (512, 4 if rgb else 2)
        assert len(got["points"]) == 3
        mask = got["point_mask"]
        assert (got["point_inds"][~mask] == -1).all()
        assert (got["point_inds"][mask] >= 0).all()
        assert mask[:mask.sum()].all()
        if rgb and split == "test":
            assert not mask.all()
    assert tm.input_width() == (4 if rgb else 2)
    if split == "test":
        np.testing.assert_array_equal(port.possibilities[0],
                                      ref.possibilities[0])


# ------------------------------------------------------------ the op

def _op_inputs(seed, nq=96, ns=128, k=10, cin=5):
    """Support points in a 0.6 m box (the last 8 padded at 1e6), queries
    on a subset, radius neighbours with the sentinel ns, features."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(-0.3, 0.3, (B, ns, 3)).astype(np.float32)
    s[:, -8:] = 1e6
    q = s[:, :nq].copy()
    q[:, -4:] = 1e6
    nb = np.stack([NativeKDTree(s[b, :-8]).query_radius_padded(
        q[b], 0.12, k, fill=ns)[0] for b in range(B)])
    x = rng.normal(0, 1, (B, ns, cin)).astype(np.float32)
    return q, s, nb, x


@pytest.mark.parametrize("deformable", [False, True],
                         ids=["rigid", "deform"])
@pytest.mark.parametrize("aggregation", ["sum", "closest"])
@pytest.mark.parametrize("influence", ["constant", "linear", "gaussian"])
def test_kpconv_op_matches_jax(influence, aggregation, deformable):
    """``KPConvOp`` on the JAX op's variables (the offset weights drawn so
    that the kernel points move), per sample in JAX and batched here: the
    output and, deformable, both regularizer terms of each sample."""
    q, s, nb, x = _op_inputs(3)
    args = (15, x.shape[-1], 7, 0.12, 0.25)  # P, Cin, Cout, extent, radius
    kw = dict(kp_influence=influence, aggregation_mode=aggregation,
              deformable=deformable)
    jop = jkp.KPConvOp(*args, **kw)
    v = jop.init(jax.random.PRNGKey(1), q[0], s[0], nb[0], x[0])
    v = {k: jax.tree.map(np.asarray, v[k]) for k in ("params", "kp_points")}
    if deformable:
        rng = np.random.default_rng(4)
        off = v["params"]["offset_conv"]["weights"]
        v["params"]["offset_conv"]["weights"] = rng.normal(
            0, 0.3, off.shape).astype(np.float32)
        v["params"]["offset_bias"] = rng.normal(0, 0.1, (45,)).astype(
            np.float32)
    want, regs = [], []
    for b in range(B):
        out, aux = jop.apply(v, q[b], s[b], nb[b], x[b], mutable=["p2p_reg"])
        want.append(np.asarray(out))
        regs.append(aux.get("p2p_reg", {}))
    top = tkp.KPConvOp(*args, **kw)
    top.load_state_dict(jax_to_state_dict(v, scope=None))
    got = top.train()(*(torch.from_numpy(a) for a in (q, s, nb, x)))
    assert _rel(got.detach().numpy(), np.stack(want)) <= TOL
    if deformable:
        for term in ("fitting", "repulsive"):
            want_t = np.array([float(r[term][0]) for r in regs])
            assert _rel(top.p2p[term].detach().numpy(), want_t) <= TOL
            assert (want_t > 0).all()
    else:
        assert top.p2p is None and not regs[0]


def test_pools_read_a_zero_shadow_row():
    """``max_pool`` over negative features with a missing neighbour gives
    0, as the JAX pool does; ``closest_pool`` of the sentinel is 0."""
    x = -np.arange(1, 13, dtype=np.float32).reshape(2, 3, 2)
    inds = np.array([[[0, 1], [2, 3]], [[1, 2], [3, 3]]], np.int32)
    got = tkp.max_pool(torch.from_numpy(x), torch.from_numpy(inds)).numpy()
    want = np.stack([np.asarray(jkp.max_pool(jnp.asarray(x[b]),
                                             jnp.asarray(inds[b])))
                     for b in range(2)])
    np.testing.assert_array_equal(got, want)
    assert (got[:, 1] == 0).all() and (got[:, 0] < 0).all()
    got = tkp.closest_pool(torch.from_numpy(x),
                           torch.from_numpy(inds[..., ::-1].copy())).numpy()
    want = np.stack([np.asarray(jkp.closest_pool(
        jnp.asarray(x[b]), jnp.asarray(inds[b, :, ::-1]))) for b in range(2)])
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- the net

def _batches(tm, jm, data, split="training", seeds=(1, 2)):
    """A batch of B transformed patches of ``data``, collated by each
    package's batcher."""
    attr = {"split": split}
    tpre, jpre = tm.preprocess(data, attr), jm.preprocess(data, attr)
    tm.trans_point_sampler = SemSegRandomSampler.get_point_sampler()
    jm.trans_point_sampler = JaxRandom.get_point_sampler()
    ts = [{"data": tm.transform(tpre, attr, rng=np.random.default_rng(s))}
          for s in seeds]
    js = [{"data": jm.transform(jpre, attr, rng=np.random.default_rng(s))}
          for s in seeds]
    return (DefaultBatcher().collate_fn(ts)["data"],
            JaxBatcher().collate_fn(js)["data"])


def to_torch(batch):
    return {k: ([torch.from_numpy(x) for x in v] if isinstance(v, list)
                else torch.from_numpy(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: ([jnp.asarray(x) for x in v] if isinstance(v, list)
                else jnp.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def small():
    """The small config's batch, the JAX net's variables (BN statistics
    drawn), its eval logits, and its train-mode logits and statistics."""
    tm, jm = _models()
    tbatch, jbatch = _batches(tm, jm, _cloud(0))
    net = jm.get_net()
    jb = to_jax(jbatch)
    v = jax.tree.map(np.asarray, jax.jit(lambda b: net.init(
        {"params": jax.random.PRNGKey(0)}, b, training=False))(jb))
    v["batch_stats"] = _randomise_stats(v["batch_stats"],
                                        np.random.default_rng(33))
    logits = np.asarray(jax.jit(lambda v, b: net.apply(
        v, b, training=False))(v, jb))
    train, upd = jax.jit(lambda v, b: net.apply(
        v, b, training=True, mutable=["batch_stats"]))(v, jb)
    return {"batch": tbatch, "variables": v, "logits": logits,
            "train_logits": np.asarray(train),
            "stats": jax.tree.map(np.asarray, upd["batch_stats"])}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_net_eval_matches_jax(small):
    net = load_jax_variables(KPFCNN(**SMALL).get_net(), small["variables"])
    with torch.no_grad():
        got = net.eval()(to_torch(small["batch"])).numpy()
    assert got.shape == (B, 512, 6)
    assert _rel(got, small["logits"]) <= TOL


def test_net_train_mode_and_statistics_match_jax(small):
    """Train mode: the logits, and every BN running statistic after the
    forward, within ``TOL``. The statistics run over every row of both
    samples, the padded rows of each level's cap included, and move by
    torch momentum 0.98, the YAML's ``batch_norm_momentum`` (flax's
    momentum is 1 minus it)."""
    net = load_jax_variables(KPFCNN(**SMALL).get_net(), small["variables"])
    with torch.no_grad():
        got = net.train()(to_torch(small["batch"])).numpy()
    assert _rel(got, small["train_logits"]) <= TOL
    back = dict(_flat(state_dict_to_jax(net.state_dict())["batch_stats"]))
    want = dict(_flat(small["stats"]))
    assert set(back) == set(want)
    for key, value in want.items():
        assert _rel(back[key], value) <= TOL, key
    assert (small["batch"]["points"][2] == 1e6).any()


def test_bn_momentum_and_padded_rows():
    """Each BatchNorm's torch momentum is ``batch_norm_momentum`` (0.98 in
    every shipped YAML, 0.02 by the class default), and its batch
    statistics take every row, the cap's padded ones included."""
    for momentum in (0.98, None):
        kw = dict(SMALL)
        if momentum is None:
            kw.pop("batch_norm_momentum")
        net = KPFCNN(**kw).get_net()
        bns = [m for m in net.modules()
               if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]
        assert bns and all(m.momentum == (momentum or 0.02) for m in bns)
    tm, jm = _models()
    tbatch, _ = _batches(tm, jm, _cloud(0))
    net = tm.get_net().train()
    seen = {}
    net.enc0.KPConv.register_forward_hook(
        lambda m, i, out: seen.setdefault("x", out.detach()))
    with torch.no_grad():
        net(to_torch(tbatch))
    rows = seen["x"].reshape(-1, seen["x"].shape[-1])
    assert rows.shape[0] == B * 512
    torch.testing.assert_close(net.enc0.simple_bn.running_mean,
                               0.98 * rows.mean(0), rtol=1e-5, atol=1e-7)


def test_decoder_names_and_convert_round_trip(small):
    """The JAX scope names (``dec1`` and ``dec3``: the upsamples count),
    and JAX -> port -> JAX: every leaf back bit for bit, the kernel
    points in ``kp_points``, ``weights`` [P, Cin, Cout] as they are."""
    net = load_jax_variables(KPFCNN(**SMALL).get_net(), small["variables"])
    names = {k.split(".")[0] for k in net.state_dict()}
    assert names == {"enc0", "enc1", "enc2", "enc3", "enc4", "enc5", "dec1",
                     "dec3", "head_mlp", "head_softmax"}
    back = state_dict_to_jax(net.state_dict())
    for collection in ("params", "batch_stats", "kp_points"):
        want = dict(_flat(small["variables"][collection]))
        got = dict(_flat(back[collection]))
        assert set(got) == set(want), collection
        for key, value in want.items():
            np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert net.enc0.KPConv.weights.shape == (15, 2, 16)
    assert "points" in dict(net.enc0.KPConv.named_buffers())


def test_seeded_init_draws_the_flax_bound():
    """A fresh KPConv's weights lie within flax's variance_scaling(2,
    fan_in, uniform) bound, sqrt(6 / (P * Cin)), and a generator seeds
    them; the kernel points are the Lloyd default."""
    op = tkp.KPConvOp(15, 8, 4, 0.12, 0.25)
    bound = (6.0 / (15 * 8)) ** 0.5
    w = op.weights.detach().abs()
    assert w.max() <= bound and w.max() > 0.9 * bound
    a, b = (tkp.KPConvOp(15, 8, 4, 0.12, 0.25) for _ in range(2))
    for op in (a, b):
        op.reset_parameters(torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.weights, b.weights, rtol=0, atol=0)
    np.testing.assert_array_equal(a.points.numpy(),
                                  jkp.kernel_point_lloyd(0.25, 15))


def test_net_refuses_features_of_another_width(small):
    net = KPFCNN(**SMALL).get_net()
    batch = to_torch(small["batch"])
    batch["features"] = torch.cat([batch["features"]] * 2, -1)
    with pytest.raises(ValueError, match="width 4"):
        net(batch)


def test_loss_and_update_probs_equal_jax(small):
    """``get_loss`` masks the padded rows by ``point_mask`` (loss within
    1e-6); ``update_probs`` skips ``point_inds`` -1 and blends at 0.98
    (probabilities within one float16 step)."""
    from open3d_ml_tpu.modules.losses import SemSegLoss as JaxLoss
    from open3d_ml_tpu_torch.modules.losses import SemSegLoss

    class Dataset:
        cfg = Config({"class_weights": [3, 1, 4, 1, 5, 9]})

    tm, jm = _models()
    batch = dict(small["batch"])
    # the padding of a ball smaller than the cap
    batch["point_mask"] = batch["point_mask"].copy()
    batch["point_mask"][:, 400:] = False
    batch["point_inds"] = np.where(batch["point_mask"],
                                   batch["point_inds"], -1)
    logits = small["logits"].copy()
    got, _, _ = tm.get_loss(SemSegLoss(None, tm, Dataset()),
                            torch.from_numpy(logits), to_torch(batch))
    want, _, _ = jm.get_loss(JaxLoss(None, jm, Dataset()),
                             jnp.asarray(logits), to_jax(batch))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    probs = np.zeros((4000, 6), np.float16)
    inputs = {"point_inds": batch["point_inds"]}
    got = tm.update_probs(inputs, logits, probs.copy())
    want = jm.update_probs(inputs, logits, probs.copy())
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), atol=1e-3 / 1024)
    assert (batch["point_inds"] == -1).any()


@pytest.mark.parametrize("name", YAMLS)
def test_defaults_and_yaml_widths(name):
    """The class defaults are the JAX class's; each shipped YAML's model
    builds (the 4-column features of ``in_features_dim`` 5 where the
    reader gives colour), with the same layers as the JAX net's tree."""
    assert KPFCNN().cfg.to_dict() == JaxKPFCNN().cfg.to_dict()
    cfg = Config.load_from_file(
        REPO / f"open3d_ml_tpu_torch/configs/kpconv_{name}.yml")
    model = KPFCNN(**cfg.model.to_dict())
    dim = cfg.model.in_features_dim
    assert model.input_width() == (dim if dim <= 2 else 4)
    net = model.get_net()
    assert net.enc0.KPConv.weights.shape[1] == model.input_width()
    assert sum(isinstance(m, tkp.KPConvOp) for m in net.modules()) == 13
    assert net.head_softmax.mlp.out_features == cfg.model.num_classes
