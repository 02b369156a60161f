"""The port's SparseConvUnet (``open3d_ml_tpu_torch``) against the JAX
package.

The JAX ``SparseConvUnet(...).get_net()`` initialises the variables; the BN
statistics are replaced by numpy draws so that BN is not the identity. The
same variables go into the port (``load_jax_variables``), the same numpy
batch through both nets in inference mode, and the logits and the overflow
counters are compared. On the CPU the JAX stencil path runs the XLA twin of
its kernel and the port the kernel's plain version.

The config is small (3 levels, multiplier 4, at most 2,048 voxels) but runs
the down and up convolutions, a ragged last query block, segment tables
short of exact and, in a second config, saturated site caps.
"""

import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open3d_ml_tpu.models import SparseConvUnet as JaxSparseConvUnet
from open3d_ml_tpu.models.common import MaskedBatchNorm as JaxMaskedBN
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch import MODEL
from open3d_ml_tpu_torch.models import SparseConvUnet
from open3d_ml_tpu_torch.models import sparseconvunet as tscu
from open3d_ml_tpu_torch.models.common import MaskedBatchNorm
from open3d_ml_tpu_torch.utils import load_jax_variables, state_dict_to_jax
from open3d_ml_tpu_torch.utils.convert_jax import jax_to_state_dict
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(multiplier=4, num_classes=5, num_levels=3, max_voxels=2048,
             num_points=1500, in_channels=3, residual_blocks=True,
             level_caps=[2048, 1024, 512], bucket_seg=32, bucket_segs=8)
# saturates the level-0 cap, the level-1 parents and the segment tables
TIGHT = dict(SMALL, max_voxels=600, level_caps=[600, 160, 64], bucket_segs=2)


def surface_batch(rng, b=2, n=1500):
    """Walls and floor of a room in voxel units, one sample with masked
    points: the surface density SparseConvUnet runs on."""
    wall = rng.uniform(0, 40, (b, n // 3, 2))
    p1 = np.stack([wall[..., 0], wall[..., 1],
                   np.full_like(wall[..., 0], 0.5)], -1)
    p2 = np.stack([wall[..., 0], np.full_like(wall[..., 0], 0.5),
                   wall[..., 1] / 2], -1)
    p3 = np.stack([np.full_like(wall[..., 0], 0.5), wall[..., 0],
                   wall[..., 1] / 2], -1)
    pts = np.concatenate([p1, p2, p3], axis=1)
    pts = (pts.astype(np.int32) + 0.5).astype(np.float32)
    mask = np.ones(pts.shape[:2], bool)
    mask[-1, -200:] = False
    return {"point": pts,
            "feat": rng.uniform(-1, 1, (*pts.shape[:2], 3)).astype(np.float32),
            "point_mask": mask}


def _randomise_stats(tree, rng):
    return {k: (_randomise_stats(v, rng) if isinstance(v, dict) else
                rng.normal(0.0, 0.2, v.shape).astype(np.float32)
                if k == "mean" else
                rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
            for k, v in tree.items()}


def _jax_run(cfg, variables, batch, eval_net=False, dtype="float32"):
    model = JaxSparseConvUnet(compute_dtype=dtype, **cfg)
    net = model.get_eval_net() if eval_net else model.get_net()
    out, inter = jax.jit(lambda v, b: net.apply(
        v, b, training=False, mutable=["intermediates"]))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()})
    counters = {k: np.asarray(v[0]) for k, v in
                inter["intermediates"]["net"].items()}
    return np.asarray(out), counters


def _reference(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = surface_batch(rng)
    net = JaxSparseConvUnet(compute_dtype="float32", **cfg).get_net()
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda b: net.init({"params": key}, b,
                                           training=False))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    variables = jax.tree.map(np.asarray, variables)
    variables = {"params": variables["params"],
                 "batch_stats": _randomise_stats(variables["batch_stats"],
                                                 rng)}
    return batch, variables


@pytest.fixture(scope="module")
def small():
    return _reference(SMALL, 0)


@pytest.fixture(scope="module")
def tight():
    return _reference(TIGHT, 1)


def _port_run(cfg, variables, batch, eval_net=False, dtype="float32"):
    model = SparseConvUnet(compute_dtype=dtype, **cfg)
    net = model.get_eval_net() if eval_net else model.get_net()
    load_jax_variables(net, variables).eval()
    with torch.no_grad():
        out = net({k: torch.from_numpy(v) for k, v in batch.items()})
    return out.numpy(), net.overflow_counts()


def _rel_l2(got, ref):
    return np.linalg.norm(got - ref) / np.linalg.norm(ref)


@pytest.mark.parametrize("eval_net", [False, True], ids=["bucket", "hash"])
@pytest.mark.parametrize("which", ["small", "tight"])
def test_logits_and_counters_match_jax_float32(request, which, eval_net):
    """Same weights, same batch, float32: relative L2 <= 1e-5 (float32
    products summed in other orders), and equal overflow counters."""
    cfg = SMALL if which == "small" else TIGHT
    batch, variables = request.getfixturevalue(which)
    ref, ref_counters = _jax_run(cfg, variables, batch, eval_net)
    got, counters = _port_run(cfg, variables, batch, eval_net)
    assert got.shape == ref.shape == (2, 1500, 5)
    assert np.isfinite(got).all()
    assert _rel_l2(got, ref) <= 1e-5, _rel_l2(got, ref)
    assert set(counters) == set(ref_counters)
    for name, value in ref_counters.items():
        np.testing.assert_array_equal(np.asarray(counters[name]), value,
                                      err_msg=name)
    if which == "tight":
        assert ref_counters["voxel_overflow_points"].sum() > 0
        assert ref_counters["l0_down_overflow_children"].sum() > 0


def test_bucket_matches_jax_bfloat16(small):
    """At bfloat16 both sides round the convolutions' inputs and weights
    to bfloat16 and sum exact products in float32, in other orders; BN,
    the shortcut and the head stay float32. Measured here: relative L2
    about 1e-6; the limit 1e-4 still catches any bf16 step that one side
    takes and the other does not (about 1e-2)."""
    batch, variables = small
    ref, _ = _jax_run(SMALL, variables, batch, dtype="bfloat16")
    got, _ = _port_run(SMALL, variables, batch, dtype="bfloat16")
    assert _rel_l2(got, ref) <= 1e-4, _rel_l2(got, ref)
    f32, _ = _port_run(SMALL, variables, batch)
    assert _rel_l2(got, f32) > 1e-4  # bf16 did round


def test_bucket_equals_hash_when_exact(small):
    """With every counter 0 (here: every segment in every table) the
    stencil path computes the hash path's function."""
    batch, variables = small
    cfg = dict(SMALL, bucket_segs=64)
    bucket, counters = _port_run(cfg, variables, batch)
    hashed, _ = _port_run(cfg, variables, batch, eval_net=True)
    assert not any(np.sum(v) for v in counters.values())
    assert _rel_l2(bucket, hashed) <= 1e-5


@pytest.mark.parametrize("levels, calls", [(3, 15), (7, 39)])
def test_stencil_calls_per_forward(monkeypatch, levels, calls):
    """One stencil_conv call per convolution: the input conv, two per
    level's block, and per level above the last a down, an up and two
    post convs."""
    seen = []
    real = tscu.stencil_conv

    def counting(values, *args, **kwargs):
        seen.append((values.shape[-1], args[3].shape))
        return real(values, *args, **kwargs)

    monkeypatch.setattr(tscu, "stencil_conv", counting)
    model = SparseConvUnet(multiplier=2, num_levels=levels, max_voxels=512,
                           num_points=800, compute_dtype="float32")
    net = model.get_net().eval()
    batch = surface_batch(np.random.default_rng(2), b=1, n=800)
    with torch.no_grad():
        net({k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(seen) == calls
    assert (sum(1 for _, w in seen if w[0] == 8) ==
            2 * (levels - 1))  # down and up


def test_masked_batch_norm_matches_flax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 50, 6)).astype(np.float32) * 3
    mask = rng.random((2, 50)) > 0.3
    stats = {"mean": rng.normal(0, 0.5, 6).astype(np.float32),
             "var": rng.uniform(0.2, 2.0, 6).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.normal(0, 0.3, 6).astype(np.float32)}
    ref = JaxMaskedBN(momentum=0.99, epsilon=1e-4, axis_name=None).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(mask), training=False)
    bn = MaskedBatchNorm(6, eps=1e-4, momentum=0.01).eval()
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    got = bn(torch.from_numpy(x), torch.from_numpy(mask)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-6)
    assert (got[~mask] == 0).all()
    # train mode: the masked batch statistics (gradients and the running
    # update: tests/test_torch_scu_train.py)
    ref = JaxMaskedBN(momentum=0.99, epsilon=1e-4, axis_name=None).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x),
        jnp.asarray(mask), training=True, mutable=["batch_stats"])[0]
    got = bn.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_net_bn_constants():
    net = SparseConvUnet().get_net()
    bn = net.l3_block0.bn2
    assert bn.eps == 1e-4 and bn.momentum == pytest.approx(0.01)
    assert net.l0_post0.lin.bias is None and net.l0_block0.lin is None
    assert net.caps == [40000, 20000, 10000, 5000, 2504, 1256, 632]
    assert tuple(net.l5_up_kernel.shape) == (8, 224, 192)


def test_convert_round_trip(small):
    """JAX -> port -> JAX on SparseConvUnet's tree: every leaf comes back
    bit for bit; stencil kernels keep their [K, Cin, Cout] layout, Dense
    kernels are transposed."""
    _, variables = small
    net = load_jax_variables(SparseConvUnet(**SMALL).get_net(), variables)
    sd = net.state_dict()
    params = variables["params"]["net"]
    np.testing.assert_array_equal(sd["l1_down_kernel"].numpy(),
                                  params["l1_down_kernel"])
    np.testing.assert_array_equal(sd["l0_block0.conv2.weight"].numpy(),
                                  params["l0_block0"]["conv2"]["kernel"])
    np.testing.assert_array_equal(sd["l0_post0.lin.weight"].numpy(),
                                  params["l0_post0"]["lin"]["kernel"].T)
    back = state_dict_to_jax(sd)
    flat = jax.tree_util.tree_leaves_with_path
    ref = dict(flat(variables))
    got = dict(flat(back))
    assert set(got) == set(ref)
    for path, value in ref.items():
        np.testing.assert_array_equal(got[path], value)
    assert "l2_up_kernel" not in str(list(jax_to_state_dict(variables)))


def test_overflow_warning(tight, small, caplog):
    """Counters that are not 0 log the JAX package's warning; 0 logs
    nothing; ``warn_on_overflow=False`` keeps quiet."""
    for which, cfg, expect in (("tight", TIGHT, True),
                               ("small", dict(SMALL, bucket_segs=64), False)):
        batch, variables = tight if which == "tight" else small
        caplog.clear()
        with caplog.at_level(logging.WARNING, tscu.__name__):
            _port_run(cfg, variables, batch)
        assert any("bucket path saturated" in r.message
                   for r in caplog.records) == expect, which
    caplog.clear()
    batch, variables = tight
    with caplog.at_level(logging.WARNING, tscu.__name__):
        _port_run(dict(TIGHT, warn_on_overflow=False), variables, batch)
    assert not caplog.records


def test_preprocess_transform_bit_equal():
    rng = np.random.default_rng(4)
    n = 5000
    data = {"point": rng.uniform(-3, 3, (n, 3)).astype(np.float32),
            "feat": rng.uniform(0, 255, (n, 3)).astype(np.float32),
            "label": rng.integers(0, 20, n).astype(np.int32)}
    data["point"][:10] += 25  # beyond the 1024-voxel extent: dropped
    for num_points in (4096, 8192):
        jm = JaxSparseConvUnet(voxel_size=0.02, num_points=num_points)
        tm = SparseConvUnet(num_points=num_points)
        attr = {"split": "test"}
        jp = jm.preprocess(data, attr, rng=np.random.default_rng(5))
        tp = tm.preprocess(data, attr, rng=np.random.default_rng(5))
        for key in jp:
            np.testing.assert_array_equal(tp[key], jp[key], err_msg=key)
        jt = jm.transform(jp, attr, rng=np.random.default_rng(6))
        tt = tm.transform(tp, attr, rng=np.random.default_rng(6))
        assert set(jt) == set(tt)
        for key in jt:
            np.testing.assert_array_equal(tt[key], jt[key], err_msg=key)


def test_update_probs_matches_jax():
    rng = np.random.default_rng(7)
    inputs = {"point_inds": np.stack([rng.permutation(300)[:200]
                                      for _ in range(2)]).astype(np.int32),
              "point_mask": rng.random((2, 200)) > 0.2}
    results = rng.normal(0, 3, (2, 200, 20)).astype(np.float32)
    ref = JaxSparseConvUnet().update_probs(inputs, results,
                                           np.zeros((300, 20), np.float32))
    got = SparseConvUnet().update_probs(inputs, results,
                                        np.zeros((300, 20), np.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_training_split_augmentation_is_not_ported():
    """The shipped recipe runs on the training split (bit-equal to the JAX
    package's: tests/test_torch_scu_train.py), and so does it with
    ``rotate`` about a random axis (``method="all"``): the same seed gives
    the JAX package's sites, features and labels."""
    data = {"point": np.random.default_rng(0).uniform(0, 2, (50, 3)),
            "feat": np.full((50, 3), 100.0, np.float32)}
    out = SparseConvUnet(seed=1).preprocess(data, {"split": "train"})
    assert 0 < len(out["point"]) <= 50
    augment = dict(SparseConvUnet().cfg.augment, rotate={"method": "all"})
    got = SparseConvUnet(augment=augment, seed=1).preprocess(
        data, {"split": "train"})
    want = JaxSparseConvUnet(augment=augment, seed=1,
                             voxel_size=SparseConvUnet().cfg.voxel_size
                             ).preprocess(data, {"split": "train"})
    assert set(got) == set(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_defaults_equal_shipped_yaml():
    cfg = Config.load_from_file(
        REPO / "open3d_ml_tpu/configs/sparseconvunet_scannet.yml")
    defaults = SparseConvUnet().cfg.to_dict()
    for key, value in cfg.model.to_dict().items():
        assert defaults[key] == value, key


def test_registry_and_unported_options():
    assert MODEL.get("SparseConvUnet") is SparseConvUnet
    with pytest.raises(NotImplementedError, match="bucket_fused"):
        SparseConvUnet(bucket_fused=False).get_net()
    with pytest.raises(ValueError, match="conv_method"):
        SparseConvUnet(conv_method="dense").get_net()


def test_new_modules_import_no_jax():
    """The SparseConvUnet slice of the port and ``chip_smoke.py`` load
    neither JAX nor the JAX package."""
    code = ("import sys\n"
            "import open3d_ml_tpu_torch.models.sparseconvunet\n"
            "import open3d_ml_tpu_torch.models.common\n"
            "import open3d_ml_tpu_torch.ops.voxelize\n"
            "import open3d_ml_tpu_torch.ops.sparse\n"
            "import open3d_ml_tpu_torch.ops.sparse_bucket\n"
            "import open3d_ml_tpu_torch.ops.cuda.stencil\n"
            "import chip_smoke\n"
            "bad = [m for m in ('jax', 'flax', 'optax', 'yaml',\n"
            "                   'open3d_ml_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_chip_smoke_scu_constants_match_yaml():
    """``chip_smoke.py`` sizes the bench request and picks the stencil
    shapes from the shipped config without reading the YAML."""
    import chip_smoke
    cfg = Config.load_from_file(
        REPO / "open3d_ml_tpu/configs/sparseconvunet_scannet.yml").model
    assert chip_smoke.SCU_BENCH_EXTENT_M == 1000 * cfg.voxel_size
    planes = [cfg.multiplier * (i + 1) for i in range(cfg.num_levels)]
    shapes = {(k, cin, cout, qblock)
              for _, k, cin, cout, qblock in chip_smoke.STENCIL_SHAPES}
    assert shapes == {(27, planes[0], planes[0], cfg.bucket_qblock),
                      (27, 2 * planes[0], planes[0], cfg.bucket_qblock),
                      (8, planes[0], planes[1], cfg.bucket_qblock),
                      (8, planes[1], planes[0], tscu.UP_QBLOCK),
                      (27, planes[-1], planes[-1], cfg.bucket_qblock)}
    assert chip_smoke.SCU_FORWARD_LAUNCHES == 1 + 2 * cfg.num_levels + 4 * (
        cfg.num_levels - 1)
