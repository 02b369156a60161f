"""RandLA-Net at the four other shipped YAMLs (S3DIS, Semantic3D, Toronto3D,
ParisLille3D) and its host-built pyramid, against the JAX package on the
CPU.

Each YAML's model section runs at small widths (``NARROW``: 1,024 points,
narrow ``dim_output``, small tables) but keeps its ``in_channels``,
``num_classes``, ratios, ``ignored_label_inds`` and its dataset's
``class_weights``. The variables are drawn with numpy on the shapes
``jax.eval_shape`` gives the JAX init (nothing compiles for them) and
go into the port with ``load_jax_variables``; the coordinates are lattice
points, on which both exact pyramids agree index for index.

The host pyramid (``knn_on_device=False``): ``DataProcessing.knn_search``
on the port's KD-tree against the JAX package's (its native tree, loaded
as ``test_torch_kpconv.load_jax_native`` loads it), ``transform``'s
pyramid against JAX's, and the net reading it in train mode against the
JAX ``BatchedNet`` (its vmapped per-sample net, BatchNorm over the batch)
with one dropout mask in both. Also ``rotate`` about a random axis and
the launch counts ``chip_smoke`` expects of a fused forward.
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from open3d_ml_tpu.datasets.augment import SemsegAugmentation as JaxAugment
from open3d_ml_tpu.datasets.augment.augmentation import (
    _rotation_matrices as jax_rotation_matrices)
from open3d_ml_tpu.datasets.utils import DataProcessing as JaxDataProcessing
from open3d_ml_tpu.models import randlanet as jrl
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxSemSegLoss
from open3d_ml_tpu.utils import Config as JaxConfig
from open3d_ml_tpu_torch.datasets.augment import SemsegAugmentation
from open3d_ml_tpu_torch.datasets.augment.augmentation import (
    _rotation_matrices)
from open3d_ml_tpu_torch.datasets.utils import DataProcessing
from open3d_ml_tpu_torch.models import RandLANet
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.utils import Config, load_jax_variables
from open3d_ml_tpu_torch.utils.convert_jax import jax_to_state_dict

from test_torch_kpconv import load_jax_native
from test_torch_ops import lattice_cloud
from test_torch_train import _FixedDropout
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
YAMLS = ("s3dis", "semantic3d", "toronto3d", "parislille3d")
B, N = 2, 1024
NARROW = dict(num_points=N, dim_output=[8, 16, 16, 16], seg=32, block=64,
              num_segs=8, gather_segs=4, infer_num_segs=6,
              infer_gather_segs=4, compute_dtype="float32")


def yaml_cfg(name, **extra):
    """(model kwargs of the port's ``randlanet_<name>.yml`` at ``NARROW``
    and ``extra``, its dataset section)."""
    cfg = Config.load_from_file(
        REPO / f"open3d_ml_tpu_torch/configs/randlanet_{name}.yml")
    model = cfg.model.to_dict()
    model.pop("name")
    return dict(model, **dict(NARROW, **extra)), cfg.dataset.to_dict()


def draw(tree, rng):
    """numpy values for a flax variable tree of zeros: kernels N(0, 1 /
    fan-in), biases N(0, 0.1), scales and variances U(0.5, 1.5), means
    N(0, 0.2)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = draw(value, rng)
            continue
        if key == "kernel":
            v = rng.normal(0, value.shape[0] ** -0.5, value.shape)
        elif key in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, value.shape)
        elif key == "mean":
            v = rng.normal(0, 0.2, value.shape)
        else:
            v = rng.normal(0, 0.1, value.shape)
        out[key] = np.asarray(v, np.float32)
    return out


def jax_variables(net, batch, seed):
    shapes = jax.eval_shape(lambda b: net.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        b, training=False), batch)
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))
    rng = np.random.default_rng(seed)
    return {c: draw(tree[c], rng) for c in ("params", "batch_stats")}


def batch_for(cfg, seed, b=B):
    rng = np.random.default_rng(seed)
    coords = lattice_cloud(rng, b, cfg["num_points"])
    feats = rng.uniform(-1, 1, (b, cfg["num_points"], cfg["in_channels"]))
    labels = rng.integers(0, cfg["num_classes"] + 1,
                          (b, cfg["num_points"]))
    return {"coords": coords, "features": feats.astype(np.float32),
            "labels": labels.astype(np.int32)}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ------------------------------------------------------------ the forwards

@pytest.fixture(scope="module")
def forwards():
    """Per YAML: the batch, the variables and the JAX logits of the fused
    net (``get_net``) and the exact eval net, in float32."""
    out = {}
    for name in YAMLS:
        cfg, _ = yaml_cfg(name)
        batch = batch_for(cfg, 3)
        jbatch = {k: jnp.asarray(batch[k]) for k in ("coords", "features")}
        model = jrl.RandLANet(**cfg)
        variables = jax_variables(model.get_net(), jbatch, 5)
        logits = {}
        for path, net in (("fused", model.get_net()),
                          ("exact", model.get_eval_net())):
            logits[path] = np.asarray(jax.jit(lambda v, b, net=net: net.apply(
                v, b, training=False))(variables, jbatch))
        out[name] = {"cfg": cfg, "batch": batch, "variables": variables,
                     "logits": logits}
    return out


@pytest.mark.parametrize("path", ["fused", "exact"])
@pytest.mark.parametrize("name", YAMLS)
def test_forward_matches_jax(forwards, name, path):
    """float32 logits of each YAML's fused and exact nets within 1e-5
    relative L2 of JAX's (6 input channels, or 3 for ParisLille3D; 13, 8
    and 9 classes), every variable carried by ``load_jax_variables``."""
    case = forwards[name]
    model = RandLANet(**case["cfg"])
    net = model.get_net() if path == "fused" else model.get_eval_net()
    load_jax_variables(net, case["variables"]).eval()
    with torch.no_grad():
        got = net({k: torch.from_numpy(case["batch"][k])
                   for k in ("coords", "features")}).numpy()
    want = case["logits"][path]
    assert got.shape == (B, N, case["cfg"]["num_classes"])
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)


@pytest.mark.parametrize("name", YAMLS)
def test_yaml_loss_matches_jax(forwards, name):
    """``get_loss`` with the YAML's ``ignored_label_inds`` and its
    dataset's ``class_weights`` (S3DIS ignores nothing; the outdoor
    YAMLs label 0 unlabelled)."""
    case = forwards[name]
    _, dataset = yaml_cfg(name)
    logits = case["logits"]["exact"].copy()
    labels = case["batch"]["labels"]
    jm = jrl.RandLANet(**case["cfg"])
    ref, ref_lab, _ = jm.get_loss(
        JaxSemSegLoss(None, jm, _Data(JaxConfig, dataset)),
        jnp.asarray(logits), {"labels": jnp.asarray(labels)})
    tm = RandLANet(**case["cfg"])
    got, lab, _ = tm.get_loss(SemSegLoss(None, tm, _Data(Config, dataset)),
                              torch.from_numpy(logits),
                              {"labels": torch.from_numpy(labels)})
    assert abs(float(got) - float(ref)) <= 1e-6 * abs(float(ref))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(ref_lab))


class _Data:
    """A stand-in dataset with the YAML's class counts."""

    def __init__(self, config, dataset):
        self.cfg = config({"class_weights": dataset["class_weights"]})
        self.name = dataset["name"]


# ---------------------------------------------------------- host pyramid

def _ties(d2):
    """[Q, k] mask of entries whose d2 is within 1e-6 (relative) of a
    neighbour in its row."""
    near = np.abs(np.diff(d2, axis=1)) <= 1e-6 * np.maximum(d2[:, 1:], 1e-12)
    edge = np.zeros((d2.shape[0], 1), bool)
    return np.concatenate([edge, near], 1) | np.concatenate([near, edge], 1)


def _same_neighbours(support, query, got, want):
    """The neighbour distances of ``got`` and ``want`` [Q, k] equal within
    1e-6, and their index sets equal wherever a row has no near tie."""
    d_got = np.square(query[:, None] - support[got]).sum(-1)
    d_want = np.square(query[:, None] - support[want]).sum(-1)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-6, atol=1e-9)
    clear = ~_ties(d_want).any(1)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.sort(got[clear], 1),
                                  np.sort(want[clear], 1))


@pytest.mark.parametrize("n, q, k", [(2000, 700, 16), (300, 300, 16),
                                     (40, 90, 16), (5, 12, 16),
                                     (2000, 500, 1)])
def test_knn_search_matches_jax(n, q, k):
    """The host exact k-NN against JAX's (its native tree above 64
    support points, scipy below): [Q, k] int32, nearest first, the
    distances within 1e-6 and the sets equal off ties; where the support
    holds fewer than k points both repeat the row in turn."""
    load_jax_native()
    rng = np.random.default_rng(n + q + k)
    support = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    query = rng.uniform(-3, 3, (q, 3)).astype(np.float32)
    got = DataProcessing.knn_search(support, query, k)
    want = JaxDataProcessing.knn_search(support, query, k)
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape == (q, k)
    _same_neighbours(support, query, got, want)
    d = np.square(query[:, None] - support[got]).sum(-1)
    assert (np.diff(d[:, :min(k, n)], axis=1) >= 0).all()
    if n < k:
        np.testing.assert_array_equal(got[:, n:2 * n], got[:, :n])


def _cloud(name, seed):
    """A preprocessed street cloud for ``name``'s model (6 channels: RGB
    features)."""
    cfg, _ = yaml_cfg(name)
    xyz, rgb, labels = chip_smoke.street_scene(6000, seed, 9)
    data = {"point": xyz.astype(np.float32), "label": labels,
            "feat": rgb.astype(np.float32) if cfg["in_channels"] == 6
            else None}
    return cfg, data


@pytest.mark.parametrize("split", ["train", "test"])
def test_transform_pyramid_matches_jax(split):
    """``transform`` with ``knn_on_device`` False at the S3DIS YAML on
    both sides from one seed: the patch, its features and labels equal,
    and per level the coordinates equal, the neighbour and upsample
    indices the same neighbours (distances within 1e-6, sets off ties),
    the pool indices the first N / ratio rows of the neighbour lists."""
    load_jax_native()
    cfg, data = _cloud("s3dis", 7)
    cfg = dict(cfg, knn_on_device=False, seed=11,
               augment={"recenter": {"dim": [0, 1]},
                        "rotate": {"method": "all"}})
    out = []
    for cls in (RandLANet, jrl.RandLANet):
        model = cls(**cfg)
        pre = model.preprocess(data, {"split": split})
        model.trans_point_sampler = _first_points
        out.append(model.transform(pre, {"split": split}))
    got, want = out
    assert set(got) == set(want)
    for key in ("coords", "features", "labels", "point_inds"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for level in range(cfg["num_layers"]):
        pts = want["coords_pyramid"][level]
        np.testing.assert_array_equal(got["coords_pyramid"][level], pts)
        _same_neighbours(pts, pts, got["neighbor_indices"][level],
                         want["neighbor_indices"][level])
        sub = pts.shape[0] // cfg["sub_sampling_ratio"][level]
        np.testing.assert_array_equal(got["sub_idx"][level],
                                      got["neighbor_indices"][level][:sub])
        _same_neighbours(pts[:sub], pts, got["interp_idx"][level],
                         want["interp_idx"][level])


def _first_points(pc, num_points, **kwargs):
    """A patch sampler for both packages: the first ``num_points``."""
    idx = np.arange(num_points)
    return pc[idx], idx, pc[:1]


def _jax_fixed_dropout(keep):
    """A flax Dropout that applies ``keep`` [N, C] (one mask for every
    sample of the vmapped batch)."""
    class FixedDropout(fnn.Module):
        rate: float
        deterministic: bool = False

        @fnn.compact
        def __call__(self, x):
            if self.deterministic:
                return x
            return jnp.where(keep, x / (1.0 - self.rate), 0.0)

    class Linen:
        def __getattr__(self, name):
            return FixedDropout if name == "Dropout" else getattr(fnn, name)

    return Linen()


def _host_steps(name, dtype, monkeypatch):
    """One train-mode forward and backward of the host-pyramid net (B = 2,
    512 points) in ``dtype`` on both sides, from the same variables,
    pyramid and dropout mask: (JAX's, the port's) {"logits", "loss",
    "grads", "stats"}."""
    load_jax_native()
    cfg, dataset = yaml_cfg(name, knn_on_device=False, num_points=512)
    batch = batch_for(cfg, 21)
    model = RandLANet(**cfg)
    pyr = [model._host_pyramid(c) for c in batch["coords"]]
    inputs = dict(batch, **{k: [np.stack([p[k][i] for p in pyr])
                                for i in range(cfg["num_layers"])]
                            for k in pyr[0]})
    floats = ("coords", "features", "coords_pyramid")
    keep = np.random.default_rng(2).random((cfg["num_points"], 32)) >= 0.5
    monkeypatch.setattr(jrl, "nn", _jax_fixed_dropout(jnp.asarray(keep)))
    jm = jrl.RandLANet(**cfg)
    jnet = jm.get_net()
    variables = jax_variables(jnet, jax.tree.map(jnp.asarray, inputs), 9)
    with jax.enable_x64(dtype == np.float64):
        cast = lambda k, a: jnp.asarray(a, dtype if k in floats else None)
        jbatch = {k: ([cast(k, a) for a in v] if isinstance(v, list)
                      else cast(k, v)) for k, v in inputs.items()}
        jvars = jax.tree.map(lambda a: jnp.asarray(a, dtype), variables)
        loss_obj = JaxSemSegLoss(None, jm, _Data(JaxConfig, dataset))

        def loss_fn(params):
            out, upd = jnet.apply(
                {"params": params, "batch_stats": jvars["batch_stats"]},
                jbatch, training=True, mutable=["batch_stats"])
            return jm.get_loss(loss_obj, out, jbatch)[0], (
                upd["batch_stats"], out)

        (loss, (stats, logits)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jvars["params"])
        as_np = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64),
                                       t)
        ref = {"logits": np.asarray(logits, np.float64),
               "loss": float(loss),
               "grads": jax_to_state_dict({"params": as_np(grads)}),
               "stats": jax_to_state_dict({"batch_stats": as_np(stats)})}

    tdt = torch.float64 if dtype == np.float64 else torch.float32
    net = load_jax_variables(model.get_net(), variables).to(tdt).train()
    net.dropout = _FixedDropout(torch.from_numpy(keep)[None])
    tin = {k: ([torch.from_numpy(a) for a in v] if isinstance(v, list)
               else torch.from_numpy(v)) for k, v in inputs.items()}
    for k in floats:
        tin[k] = ([a.to(tdt) for a in tin[k]] if isinstance(tin[k], list)
                  else tin[k].to(tdt))
    loss_obj = SemSegLoss(None, model, _Data(Config, dataset))
    loss_obj.class_weights = loss_obj.class_weights.to(tdt)
    out = net(tin)
    loss = model.get_loss(loss_obj, out, tin)[0]
    loss.backward()
    got = {"logits": out.detach().double().numpy(),
           "loss": float(loss.detach()),
           "grads": {n: p.grad.double().numpy()
                     for n, p in net.named_parameters()},
           "stats": {k: v.double().numpy()
                     for k, v in net.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}}
    return ref, got


def _apart(ref, got):
    names = sorted(ref["grads"])
    assert names == sorted(got["grads"])
    assert set(ref["stats"]) == set(got["stats"]) and got["stats"]
    flat = lambda g: np.concatenate([np.asarray(g[k]).ravel()
                                     for k in names])
    return {"logits": _rel_l2(got["logits"], ref["logits"]),
            "loss": abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
            "grads": _rel_l2(flat(got["grads"]),
                             flat({k: v.numpy()
                                   for k, v in ref["grads"].items()})),
            "stats": max(_rel_l2(got["stats"][k], ref["stats"][k].numpy())
                         for k in got["stats"])}


@pytest.mark.parametrize("name", ["s3dis"])
def test_host_pyramid_train_step_matches_batched_net(name, monkeypatch):
    """One train-mode forward and backward on the host pyramid
    (``knn_on_device=False``) against the JAX ``BatchedNet`` reading the
    same pyramid (per-sample nets under ``nn.vmap``, BatchNorm over the
    batch axis) with one dropout mask. In float64 on both sides: logits,
    loss, every gradient and the running statistics within 1e-6. In
    float32: logits, loss and statistics within 1e-4; the gradients are
    ill-conditioned at this size (the deepest level's BatchNorm sees 4
    points; measured, the port's float32 gradient lies 5.5e-4 from its
    float64 one and JAX's 2.0e-3), so the port's float32 gradient must lie
    no farther from the float64 gradient than JAX's float32 gradient does
    (x 1.1)."""
    ref64, got64 = _host_steps(name, np.float64, monkeypatch)
    apart = _apart(ref64, got64)
    assert max(apart.values()) <= 1e-6, apart
    ref32, got32 = _host_steps(name, np.float32, monkeypatch)
    apart = _apart(ref32, got32)
    assert max(apart["logits"], apart["loss"], apart["stats"]) <= 1e-4, \
        apart
    names = sorted(got64["grads"])
    flat = lambda g: np.concatenate([np.asarray(g[k]).ravel()
                                     for k in names])
    exact = flat(got64["grads"])
    port = _rel_l2(flat(got32["grads"]), exact)
    jax32 = _rel_l2(flat({k: v.numpy() for k, v in ref32["grads"].items()}),
                    exact)
    assert port <= 1.1 * jax32, (port, jax32)


def test_host_pyramid_batches_and_moves_per_level():
    """The batcher stacks each level of the host pyramid across samples,
    and the pipeline moves every level to its device with the batch."""
    from open3d_ml_tpu_torch.dataloaders import DefaultBatcher
    from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
    cfg, data = _cloud("toronto3d", 3)
    model = RandLANet(**dict(cfg, knn_on_device=False, seed=1))
    pre = model.preprocess(data, {"split": "train"})
    model.trans_point_sampler = _first_points
    samples = [{"data": model.transform(pre, {"split": "train"})}
               for _ in range(3)]
    batch = DefaultBatcher().collate_fn(samples)
    for key in ("coords_pyramid", "neighbor_indices", "sub_idx",
                "interp_idx"):
        levels = batch["data"][key]
        assert len(levels) == cfg["num_layers"]
        assert all(a.shape[0] == 3 for a in levels), key
    pipe = SemanticSegmentation(model, device="cpu", seed=0)
    moved = pipe._device_batch(batch)
    n = cfg["num_points"]
    assert [tuple(t.shape) for t in moved["neighbor_indices"]] == [
        (3, n // 4 ** i, 16) for i in range(cfg["num_layers"])]
    assert [tuple(t.shape) for t in moved["interp_idx"]] == [
        (3, n // 4 ** i, 1) for i in range(cfg["num_layers"])]
    with torch.no_grad():
        assert pipe.eval_net.eval()(moved).shape == (3, n, 8)


# ------------------------------------------------------------------ rotate

def test_rotate_all_matches_jax():
    """``rotate`` with ``method="all"``: the matrices of random axes and
    angles within 1e-6 of JAX's, and one seed's draws (theta, phi, then
    alpha) rotating a cloud to JAX's points."""
    rng = np.random.default_rng(0)
    axes = rng.normal(size=(50, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = rng.uniform(0, 2 * np.pi, 50)
    got = _rotation_matrices(axes, angles)
    want = jax_rotation_matrices(axes, angles)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.einsum("nij,nkj->nik", got, got),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-6)
    pc = rng.uniform(-5, 5, (400, 3)).astype(np.float32)
    pc[:, :2] -= pc[:, :2].mean(0)
    cfg = {"rotate": {"method": "all"}}
    for seed in range(4):
        np.testing.assert_allclose(
            SemsegAugmentation(cfg, seed=seed).augment(pc.copy(), None,
                                                       None, cfg)[0],
            JaxAugment(cfg, seed=seed).augment(pc.copy(), None, None,
                                               cfg)[0], rtol=0, atol=1e-6)


# ------------------------------------------------------ chip_smoke's counts

@pytest.mark.parametrize("n", [1024, 1280, 2816])
def test_fused_launches_count_the_searches(n):
    """``chip_smoke.fused_launches`` against the ``knn_bucket`` calls of a
    fused pyramid captured on the CPU (``chip_smoke.fused_searches``), at
    point counts whose levels are and are not whole query blocks; at the
    YAMLs' full sizes every level of 40,960 and 65,536 points is, while
    SemanticKITTI's and PandaSet's 45,056 have one pool search."""
    model = RandLANet(**yaml_cfg("semantic3d", num_points=n)[0])
    pts = torch.from_numpy(lattice_cloud(np.random.default_rng(n), 1, n))
    calls = chip_smoke.fused_searches(pts, model.cfg, 6, 4)
    assert chip_smoke.fused_launches(model.cfg) == {
        "bucket_knn": len(calls), "bucket_gather": 16}
    full = {name: chip_smoke.fused_launches(
        chip_smoke.randla_yaml(name).cfg)["bucket_knn"]
        for name in chip_smoke.RC_CONFIGS}
    assert full == dict(dict.fromkeys(chip_smoke.RC_CONFIGS, 4), Pandaset=5)
    assert chip_smoke.fused_launches(RandLANet().cfg) == {
        k: v for k, v in chip_smoke.EXPECTED_LAUNCHES.items() if v}
