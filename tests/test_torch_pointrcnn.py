"""The port's PointRCNN serving path (``open3d_ml_tpu_torch``) against the
JAX package, on the CPU: the ball query, PointNet++'s modules and
backbone, the bin decoding, ``roipool3d``, the proposal layer, the whole
RCNN-mode net and ``inference_end``. The NMS is held in
``test_torch_nms.py``, the pipelines and the command line in
``test_torch_pointrcnn_pipeline.py``.

Inputs are made with numpy from a seed and go through both packages; the
nets run on the JAX net's variables (weights drawn with numpy at a
1 / sqrt(fan-in) scale and BN statistics drawn, so that no layer is near
the identity and the RPN's scores spread), carried into the port by
``utils/convert_jax.py``. On the CPU the JAX ball query takes its XLA
route (a matrix product and ``lax.top_k``) and the port's the plain
version of ``knn_exact``.

Tolerances, each with its reason:

* ``TOL`` = 1e-5, float32 relative L2 of network outputs: the matrix
  products sum in other orders (measured 4e-7 on the RPN, 2e-6 on the
  refined scores), and XLA fuses the decode.
* Ball query: on grid points every d2 is exact, so the indices are
  equal; on uniform floats the two d2 formulas round apart, so a row may
  differ only where two candidates' d2, or a d2 and r^2, lie within
  ``NEAR`` (relative) of each other, and at most ``SWAP_SHARE`` of the
  rows may (0 measured at these seeds).
* The whole RCNN-mode forward runs end to end on a dense scene of grid
  points (``dense_scene``), where the RPN's neighbours are exact and its
  scores well apart. The RCNN stage groups points rotated into each
  roi's frame, off the grid: a roi whose groupings hold a near tie
  (``near_tie_rois``) may differ; the rest are held to ``TOL``. On a
  sparse scene many points have near-equal RPN scores (isolated points
  share their level-0 features), 1e-7 apart, so rounding can reorder
  the proposals; there the port's later stages are fed the JAX RPN's
  outputs (a replay) and held to the JAX net's."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from open3d_ml_tpu.datasets.utils import DataProcessing as JaxDP
from open3d_ml_tpu.models import PointRCNN as JaxPointRCNN
from open3d_ml_tpu.models import point_rcnn as jpr
from open3d_ml_tpu.models import pointnet2 as jp2
from open3d_ml_tpu.ops import neighbors as jn
from open3d_ml_tpu.utils import Config
from open3d_ml_tpu_torch import MODEL
from open3d_ml_tpu_torch.datasets import KITTI
from open3d_ml_tpu_torch.datasets.utils import DataProcessing
from open3d_ml_tpu_torch.models import PointRCNN, Pointnet2MSG
from open3d_ml_tpu_torch.models import point_rcnn as tpr
from open3d_ml_tpu_torch.models import pointnet2 as tp2
from open3d_ml_tpu_torch.ops import neighbors as tn
from open3d_ml_tpu_torch.utils import load_jax_variables
from open3d_ml_tpu_torch.utils.convert_jax import (net_layout,
                                                  state_dict_to_jax)

from test_torch_ops import lattice_cloud

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
NEAR = 1e-5  # relative d2 gap inside which two neighbours may swap
# absolute d2 gap (m^2) of the same in a roi's frame: the packages' d2
# formulas, |q|^2 + |p|^2 - 2 q.p, round apart by a few ulps of |q|^2 +
# |p|^2 (<= 50 m^2 within a roi grown by 1 m; an ulp 4e-6)
NEAR_D2 = 2e-5
# relative gap of FPS's running distances inside which its argmax may
# differ: sums of three squared differences, a few ulps apart at most
NEAR_FPS = 1e-6
# rois of the dense lattice scene flagged by ``near_tie_rois``: distances
# equal on the grid stay equal but for rounding once rotated into a roi's
# frame (53 of 128 flagged); on the generic sparse scene none are
TIED_SHARE = 0.5
# the same on generic points at the shipped width (512 points a roi, 160
# centres of 64 neighbours): 3 of 100 flagged
GENERIC_TIED_SHARE = 0.05
SWAP_SHARE = 0.01  # of the query rows, at most
HEAD = {"nms_pre": 512, "nms_post": 64,
        "mean_size": [1.52563191462, 1.62856739989, 3.88311640418]}
# the shipped widths but for the RCNN stage, narrower, and the SA levels'
# sample counts (tests/test_pointrcnn.py's)
SMALL = dict(
    npoints=1024, seed=0,
    rpn={"backbone": {"npoints": [256, 64, 16, 4]}, "head": HEAD},
    rcnn={"SA_config": {"npoints": [32, 8, -1], "radius": [0.2, 0.4, 100],
                        "nsample": [16, 16, 16],
                        "mlps": [[64, 64], [64, 128], [128, 256]]},
          "xyz_up_layer": [64, 64], "cls_out_ch": [128], "reg_out_ch": [128],
          "head": {"nms_pre": 32, "nms_post": 32, "get_ry_fine": True,
                   "loc_scope": 1.5, "num_head_bin": 9, "nms_thres": 0.1,
                   "mean_size": HEAD["mean_size"]},
          "target_head": {"num_points": 64}})


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def draw_variables(tree, rng):
    """Flax variables with every leaf drawn: kernels N(0, 1 / fan-in),
    biases N(0, 0.1), BN scales and variances U(0.5, 1.5), means
    N(0, 0.2)."""
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = draw_variables(x, rng)
        elif k == "kernel":
            out[k] = rng.standard_normal(x.shape) / np.sqrt(x.shape[0])
        elif k in ("bias", "mean"):
            out[k] = rng.normal(0.0, 0.1 if k == "bias" else 0.2, x.shape)
        else:  # scale, var
            out[k] = rng.uniform(0.5, 1.5, x.shape)
        if not isinstance(x, dict):
            out[k] = out[k].astype(np.float32)
    return out


def jax_variables(module, *args, seed=0, **kwargs):
    key = jax.random.PRNGKey(seed)
    v = jax.jit(lambda *a: module.init({"params": key, "dropout": key}, *a,
                                       **kwargs))(*args)
    v = jax.tree.map(np.asarray, dict(v))
    rng = np.random.default_rng(seed)
    return {c: draw_variables(v[c], rng) for c in ("params", "batch_stats")
            if c in v}


def dense_scene(rng, b=2, n=1024, far=324):
    """A dense cube of 4 m near the camera and one at 41-45 m (both
    proposal buckets), every point with neighbours at the first radius,
    so the RPN's scores lie well apart. The near points lie on the 1/64
    grid and the far ones on the 1/8 grid: every d2 the ball queries,
    3-NN and FPS rank by is exact in float32 within a cube, so both
    packages pick the same neighbours and centres."""
    def grid(count, cells, step):
        v = np.stack([rng.choice(cells ** 3, count, replace=False)
                      for _ in range(b)])
        return np.stack([v % cells, (v // cells) % cells, v // cells ** 2],
                        -1) * step
    pts = np.concatenate([grid(n - far, 256, 1 / 64),
                          grid(far, 32, 1 / 8) + [0, 0, 41]], 1)
    return pts[:, rng.permutation(n)].astype(np.float32)


# ------------------------------------------------------------ host helpers

def test_invT_and_cam2world_equal_jax():
    rng = np.random.default_rng(0)
    world_cam = rng.normal(0, 1, (4, 4)).astype(np.float32)
    world_cam[:, 3] = [0, 0, 0, 1]
    pts = rng.uniform(-40, 40, (50, 3)).astype(np.float32)
    np.testing.assert_array_equal(DataProcessing.invT(world_cam),
                                  JaxDP.invT(world_cam))
    got = DataProcessing.cam2world(pts, world_cam)
    np.testing.assert_array_equal(got, JaxDP.cam2world(pts, world_cam))
    back = DataProcessing.world2cam(got, world_cam)
    np.testing.assert_allclose(back, pts, atol=1e-3)


# ------------------------------------------------------- ball query, radius

def _near_tie_rows(d2_all, k, r2):
    """Rows of the [Q, N] float64 distances where the k-th and the
    (k+1)-th nearest, or a distance and r2, lie within NEAR."""
    s = np.sort(d2_all, axis=1)
    kk = min(k, s.shape[1] - 1)
    gap = np.abs(s[:, kk] - s[:, kk - 1]) <= NEAR * np.maximum(s[:, kk], 1e-9)
    edge = (np.abs(s[:, :k] - r2) <= NEAR * r2).any(1)
    return gap | edge


@pytest.mark.parametrize("kind", ["lattice", "uniform"])
@pytest.mark.parametrize("radius,k", [(0.5, 16), (1.0, 32), (0.3, 64)])
def test_ball_query_equals_jax(kind, radius, k):
    """The port's ball query (the nearest k by ``knn_exact``'s plain
    version, masked to the radius, empty slots the nearest point) against
    JAX's ``ball_query``: equal on the lattice; on uniform points equal
    but in rows with a near tie (at most ``SWAP_SHARE`` of them)."""
    rng = np.random.default_rng(3)
    if kind == "lattice":
        pts = lattice_cloud(rng, 1, 1024)[0] / 2
    else:
        pts = rng.uniform(-2, 2, (1024, 3)).astype(np.float32)
    qs = np.ascontiguousarray(pts[::4])
    want_i, want_m = jax.jit(
        lambda p, q: jn.ball_query(p, q, radius, k))(pts, qs)
    got_i, got_m = tn.ball_query(torch.from_numpy(pts), torch.from_numpy(qs),
                                 radius, k)
    got_i, got_m = _np(got_i), _np(got_m)
    assert got_i.shape == (256, k) and got_m.dtype == bool
    differ = (got_i != np.asarray(want_i)).any(1) | \
        (got_m != np.asarray(want_m)).any(1)
    if kind == "lattice":
        assert not differ.any()
    else:
        d2 = ((qs[:, None].astype(np.float64) - pts[None]) ** 2).sum(-1)
        ties = _near_tie_rows(d2, k, np.float32(radius) ** 2)
        assert not (differ & ~ties).any()
        assert differ.sum() <= SWAP_SHARE * len(qs)
    assert 0 < got_m.mean() < 1  # some slots outside the radius
    # the slots outside are the nearest point's
    np.testing.assert_array_equal(
        got_i[~got_m], np.broadcast_to(got_i[:, :1], got_i.shape)[~got_m])


def test_ball_query_batched_and_radius_search_counts():
    """A batch [B, Q, k] equals its samples searched alone; with a mask;
    ``radius_search``'s indices, mask and uncapped counts equal JAX's on
    the lattice (counts over every point, the masked never)."""
    rng = np.random.default_rng(4)
    pts = lattice_cloud(rng, 2, 600) / 2
    qs = np.ascontiguousarray(pts[:, ::3])
    mask = rng.random((2, 600)) < 0.8
    bi, bm = tn.ball_query(torch.from_numpy(pts), torch.from_numpy(qs), 1.0,
                           16, points_mask=torch.from_numpy(mask))
    for b in range(2):
        si, sm = tn.ball_query(torch.from_numpy(pts[b]),
                               torch.from_numpy(qs[b]), 1.0, 16,
                               points_mask=torch.from_numpy(mask[b]))
        assert torch.equal(bi[b], si) and torch.equal(bm[b], sm)
        want = jax.jit(lambda p, q, m: jn.radius_search(
            p, q, 1.0, 16, points_mask=m))(pts[b], qs[b], mask[b])
        got = tn.radius_search(torch.from_numpy(pts[b]),
                               torch.from_numpy(qs[b]), 1.0, 16,
                               points_mask=torch.from_numpy(mask[b]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert int(_np(got[2]).max()) > 16  # counts are not capped
        assert mask[b][_np(got[0])[_np(got[1])]].all()


# --------------------------------------------------------------- PointNet++

def _load(net, variables):
    """JAX variables of a module at the tree's root into ``net``."""
    net.JAX_SCOPE = None
    return load_jax_variables(net, variables).eval()


def _small_cloud(rng, b, n, c=0):
    """Points of the 1/256 grid in [-0.5, 0.5)^3 (every d2 and FPS
    distance exact in float32; dense for the radii), features N(0, 1)."""
    pts = lattice_cloud(rng, b, n) / 8
    return pts, rng.normal(0, 1, (b, n, c)).astype(np.float32)


@pytest.mark.parametrize("npoint", [64, None])
def test_sa_module_equals_jax(npoint):
    """``PointnetSAModuleMSG``, grouped (two scales) and group-all, on a
    batch against the JAX module per sample: centres equal, features
    within ``TOL``."""
    rng = np.random.default_rng(7)
    xyz, feats = _small_cloud(rng, 2, 256, 8)
    jm = jp2.PointnetSAModuleMSG(npoint=npoint, radii=(0.1, 0.2),
                                 nsamples=(8, 16), mlps=((16, 16), (16, 32)))
    v = jax_variables(jm, xyz[0], feats[0])
    apply = jax.jit(lambda x, f: jm.apply(v, x, f))
    want = [jax.tree.map(np.asarray, apply(xyz[b], feats[b]))
            for b in range(2)]
    port = _load(tp2.PointnetSAModuleMSG(npoint, (0.1, 0.2), (8, 16),
                                         ((16, 16), (16, 32)),
                                         in_channels=8), v)
    with torch.no_grad():
        new_xyz, new_feats = port(torch.from_numpy(xyz),
                                  torch.from_numpy(feats))
    assert new_feats.shape == (2, npoint or 1, 48)
    for b in range(2):
        np.testing.assert_array_equal(_np(new_xyz[b]), want[b][0])
        assert _rel(_np(new_feats[b]), want[b][1]) <= TOL


def test_fp_module_equals_jax():
    rng = np.random.default_rng(8)
    unknown, ufeat = _small_cloud(rng, 2, 128, 4)
    known, kfeat = _small_cloud(rng, 2, 32, 8)
    jm = jp2.PointnetFPModule(mlp=(32, 16))
    v = jax_variables(jm, unknown[0], known[0], ufeat[0], kfeat[0])
    port = _load(tp2.PointnetFPModule((32, 16), 12), v)
    with torch.no_grad():
        got = _np(port(*(torch.from_numpy(a) for a in
                         (unknown, known, ufeat, kfeat))))
    apply = jax.jit(lambda *a: jm.apply(v, *a))
    for b in range(2):
        want = np.asarray(apply(unknown[b], known[b], ufeat[b], kfeat[b]))
        assert _rel(got[b], want) <= TOL


def test_pointnet2msg_equals_jax():
    """The RPN's backbone at the shipped widths, radii and sample counts
    but for the levels' centres (256/64/16/4 of 1,024 points): xyz equal,
    features within ``TOL``; registered in the port's ``MODEL``."""
    rng = np.random.default_rng(9)
    pts, _ = _small_cloud(rng, 2, 1024)
    cfg = PointRCNN(**SMALL).backbone_cfg()
    assert cfg["sa_npoints"] == (256, 64, 16, 4)
    jm = jp2.Pointnet2MSG(**cfg)
    port = Pointnet2MSG(**cfg).eval()
    # the variables drawn into the port's tree (the whole net's fixture
    # holds that tree to JAX's)
    rng = np.random.default_rng(0)
    v = {c: draw_variables(tree, rng) for c, tree in
         state_dict_to_jax(port.state_dict(), scope=None).items()}
    _load(port, v)
    with torch.no_grad():
        xyz, feats = port(torch.from_numpy(pts))
    assert feats.shape == (2, 1024, 128)
    for b in range(2):
        wx, wf = jax.jit(lambda p: jm.apply(v, p))(pts[b])
        np.testing.assert_array_equal(_np(xyz[b]), np.asarray(wx))
        assert _rel(_np(feats[b]), wf) <= TOL
    assert MODEL.get("Pointnet2MSG") is Pointnet2MSG


# ----------------------------------------------------------- PointRCNN ops

@pytest.mark.parametrize("stage", ["rpn", "rcnn"])
def test_decode_bbox_target_equals_jax(stage):
    """The bin decoding around points (the RPN's head: 12 heading bins,
    the coarse heading) and around rois (the RCNN's: 9 bins, the fine
    heading, rotated back by each roi's ry), within 1e-6 of
    max(1, |value|)."""
    rng = np.random.default_rng(10)
    hc = PointRCNN(**SMALL).rpn_head_cfg if stage == "rpn" else \
        PointRCNN(**SMALL).rcnn_head_cfg
    n = 300
    reg = rng.normal(0, 1, (n, hc.reg_channels)).astype(np.float32)
    roi = rng.uniform(-20, 20, (n, 3 if stage == "rpn" else 7))
    if stage == "rcnn":
        roi[:, 3:6] = rng.uniform(1, 4, (n, 3))
        roi[:, 6] = rng.uniform(-np.pi, np.pi, n)
    roi = roi.astype(np.float32)
    kw = dict(get_xz_fine=True, get_y_by_bin=hc.get_y_by_bin,
              loc_y_scope=hc.loc_y_scope, loc_y_bin_size=hc.loc_y_bin_size,
              get_ry_fine=hc.get_ry_fine)
    args = (hc.loc_scope, hc.loc_bin_size, hc.num_head_bin, hc.mean_size)
    want = np.asarray(jax.jit(lambda r, p: jpr.decode_bbox_target(
        r, p, *args, **kw))(roi, reg))
    got = _np(tpr.decode_bbox_target(torch.from_numpy(roi),
                                      torch.from_numpy(reg), *args, **kw))
    assert got.shape == (n, 7)
    assert (np.abs(got - want) <= 1e-6 * np.maximum(1, np.abs(want))).all()


def test_roipool3d_equals_jax():
    """The first 16 in-box points of each roi in index order, a roi with
    fewer points backfilled with its first, an empty roi with point 0;
    equal to JAX's per sample."""
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-10, 10, (2, 500, 3)).astype(np.float32)
    feats = rng.normal(0, 1, (2, 500, 4)).astype(np.float32)
    rois = np.tile(np.asarray([[0, 1, 5, 1.5, 1.6, 3.9, 0.3],
                               [50, 1, 70, 1.5, 1.6, 3.9, 0.0],
                               [2, 2, -3, 6, 5, 7, -1.0]], np.float32),
                   (2, 1, 1))
    pooled, empty = tpr.roipool3d(torch.from_numpy(xyz),
                                  torch.from_numpy(feats),
                                  torch.from_numpy(rois), 1.0, 16)
    assert pooled.shape == (2, 3, 16, 7)
    for b in range(2):
        wp, we = jax.jit(lambda x, f, r: jpr.roipool3d(x, f, r, 1.0, 16))(
            xyz[b], feats[b], rois[b])
        np.testing.assert_array_equal(_np(pooled[b]), np.asarray(wp))
        np.testing.assert_array_equal(_np(empty[b]), np.asarray(we))
    assert _np(empty)[:, 1].all() and not _np(empty)[:, 2].any()
    np.testing.assert_array_equal(_np(pooled)[0, 1],
                                  np.broadcast_to(np.concatenate(
                                      [xyz[0, 0], feats[0, 0]]), (16, 7)))


# ---------------------------------------------------------- the whole net

@pytest.fixture(scope="module")
def nets():
    """The JAX and the port's RCNN-mode nets at ``SMALL`` on drawn
    variables, and the JAX outputs on a dense and a sparse scene."""
    rng = np.random.default_rng(12)
    dense = dense_scene(rng)
    sparse = rng.uniform(0, 30, (2, 1024, 3)).astype(np.float32)
    jmodel = JaxPointRCNN(**dict(SMALL, mode="RCNN"))
    jnet = jmodel.get_net()
    v = jax_variables(jnet, {"point": dense}, training=False)
    apply = jax.jit(lambda v, p: jnet.apply(v, {"point": p},
                                            training=False))
    want = {name: jax.tree.map(np.asarray, apply(v, pts))
            for name, pts in (("dense", dense), ("sparse", sparse))}
    jrpn = JaxPointRCNN(**dict(SMALL, mode="RPN"))
    rpn_apply = jax.jit(lambda v, p: jrpn.get_net().apply(
        v, {"point": p}, training=False))
    rpn = {name: jax.tree.map(np.asarray, rpn_apply(v, pts))
           for name, pts in (("dense", dense), ("sparse", sparse))}
    model = PointRCNN(**dict(SMALL, mode="RCNN"))
    net = load_jax_variables(model.get_net(), v).eval()
    with torch.no_grad():
        own = net({"point": torch.from_numpy(dense)})
    return {"jmodel": jmodel, "jrpn": jrpn, "v": v, "model": model,
            "net": net, "points": {"dense": dense, "sparse": sparse},
            "want": want, "rpn": rpn, "own_dense": own}


def _near(hi, lo, tol):
    """hi >= lo apart, but within ``tol``: equal values (the duplicated
    rows of a roi's pooled points) break alike in both packages, by
    index."""
    gap = hi - lo
    return (gap > 0) & (gap <= tol)


def near_tie_rois(net, pts_input):
    """[B, R] bool: the rois whose RCNN groupings hold a near tie. For
    each set abstraction but the last (group-all), its FPS centres
    (float64 distances from the float32 points) and each centre's ball
    query: a roi is flagged where FPS's best and second-best distance,
    the k-th and (k+1)-th nearest (the k-th within the radius), or a
    distance and r^2 lie apart but within ``NEAR_FPS`` (relative, FPS)
    or ``NEAR_D2`` (absolute, the ball query) of each other. Elsewhere
    both packages pick the same centres and neighbours."""
    b, r = pts_input.shape[:2]
    cur = pts_input[..., :3].reshape(b * r, -1, 3).double()
    flags = torch.zeros(b * r, dtype=torch.bool)
    for i in range(net.rcnn.levels):
        sa = getattr(net.rcnn, f"sa{i}")
        if sa.group_all:
            break
        n = cur.shape[1]
        dist = torch.full((b * r, n), float("inf"), dtype=torch.float64)
        last = torch.zeros(b * r, dtype=torch.long)
        rows = torch.arange(b * r)
        chosen = [last]
        for _ in range(1, sa.npoint):
            dist = torch.minimum(dist, ((cur - cur[rows, last][:, None]) ** 2
                                        ).sum(-1))
            top = dist.topk(2, dim=1).values
            flags |= _near(top[:, 0], top[:, 1], NEAR_FPS * top[:, 0])
            last = dist.argmax(dim=1)
            chosen.append(last)
        centres = cur[rows[:, None], torch.stack(chosen, 1)]
        d2 = ((centres[:, :, None] - cur[:, None]) ** 2).sum(-1).sort(-1)
        d2 = d2.values
        k, r2 = min(sa.nsamples[0], n), float(np.float32(sa.radii[0]) ** 2)
        if k < n:
            # a swap at the k-th place matters only inside the radius
            flags |= (_near(d2[..., k], d2[..., k - 1], NEAR_D2) &
                      (d2[..., k - 1] <= r2 + NEAR_D2)).any(-1)
        flags |= ((d2[..., :k] - r2).abs() <= NEAR_D2).any((-1, -2))
        cur = centres
    return _np(flags.reshape(b, r))


def _outputs_close(got, want, tied=None):
    """The proposals within ``TOL``, their validity equal, and the RCNN's
    cls and reg within ``TOL`` on every roi but the ``tied`` ones."""
    ok = np.ones(want["valid"].shape, bool) if tied is None else ~tied
    for key in ("rois", "scores", "cls", "reg"):
        g, w = _np(got[key]), want[key]
        if key in ("cls", "reg"):
            g, w = g[ok], w[ok]
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=key)
        assert _rel(g[fin], w[fin]) <= TOL, key
    np.testing.assert_array_equal(_np(got["valid"]), want["valid"])


def test_rcnn_forward_equals_jax(nets):
    """Mode RCNN, eval, end to end on the dense scene: the rois, their
    scores and validity within ``TOL`` of the JAX net's, from one
    ``load_jax_variables``; the refinement's cls and reg within ``TOL``
    on every roi whose RCNN groupings hold no near tie
    (``near_tie_rois``: the pooled points are rotated into each roi's
    frame, off the grid, so the two packages' d2 formulas may order a
    near tie apart; 1 of these 128 rois does), at most ``TIED_SHARE`` of
    the rois flagged. The replay below holds every roi on generic
    points."""
    net = nets["net"]
    pts = torch.from_numpy(nets["points"]["dense"])
    got = nets["own_dense"]
    with torch.no_grad():
        cls, reg, xyz, feats = net.rpn(pts)
        tied = near_tie_rois(net, net.pool(cls, xyz, feats, got["rois"]))
    want = nets["want"]["dense"]
    assert got["rois"].shape == (2, 64, 7) and got["reg"].shape == (2, 64, 46)
    assert want["valid"].sum() > 0
    assert tied.mean() <= TIED_SHARE
    _outputs_close(got, want, tied)


def test_rcnn_replay_on_jax_rpn(nets):
    """The sparse scene, where near-equal RPN scores make the proposals'
    order a matter of rounding: the port's proposal layer, pooling and
    RCNN net fed the JAX RPN's outputs give the JAX net's outputs: the
    same proposals (the boxes within ``TOL``: XLA fuses the decode into
    the net), cls and reg within ``TOL``; the port's own RPN within
    ``TOL`` of JAX's."""
    pts = nets["points"]["sparse"]
    rpn = nets["rpn"]["sparse"]
    net = nets["net"]
    with torch.no_grad():
        own = net.rpn(torch.from_numpy(pts))
        for got, key in zip(own, ("cls", "reg", "xyz", "feats")):
            assert _rel(_np(got), rpn[key]) <= TOL, key
        cls, reg, xyz, feats = (torch.from_numpy(rpn[k]) for k in
                                ("cls", "reg", "xyz", "feats"))
        rois, scores, valid = net.proposals(cls, reg, xyz)
        want = nets["want"]["sparse"]
        pts_input = net.pool(cls, xyz, feats, rois)
        rcls, rreg = net.rcnn(pts_input.reshape(-1, *pts_input.shape[2:]))
    b, r = want["valid"].shape
    tied = near_tie_rois(net, pts_input)
    assert tied.mean() <= SWAP_SHARE
    _outputs_close({"rois": rois, "scores": scores, "valid": valid,
                    "cls": rcls.reshape(b, r, -1),
                    "reg": rreg.reshape(b, r, -1)}, want, tied)


def _boxes_close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.label_class == w.label_class
        np.testing.assert_allclose(g.to_xyzwhlr(), w.to_xyzwhlr(), rtol=tol,
                                   atol=tol)
        assert g.confidence == pytest.approx(w.confidence, rel=tol)


def test_inference_end_boxes_equal_jax(nets, tmp_path):
    """The refined boxes (decode around the rois, score threshold,
    refinement NMS, camera to lidar through a KITTI calib) of the JAX
    outputs through both models' ``inference_end``, and of the port's
    own outputs."""
    chip_smoke.write_kitti_frame(tmp_path, "training", 0, 3)
    calib = KITTI.read_calib(tmp_path / "training/calib/000000.txt")
    inputs = {"calib": {k: np.stack([calib[k]] * 2)
                        for k in ("world_cam", "cam_img")}}
    want = nets["jmodel"].inference_end(nets["want"]["dense"], inputs)
    jax_out = {k: torch.from_numpy(v)
               for k, v in nets["want"]["dense"].items()}
    got = nets["model"].inference_end(jax_out, inputs)
    assert [len(b) for b in got] == [len(b) for b in want]
    assert sum(len(b) for b in want) > 0
    for g, w in zip(got, want):
        _boxes_close(g, w, tol=1e-6)
    for g, w in zip(nets["model"].inference_end(nets["own_dense"], inputs),
                    want):
        _boxes_close(g, w)


def test_convert_jax_round_trip(nets):
    """The JAX variables -> the port's state_dict -> JAX variables: every
    leaf back, equal (Dense kernels transposed twice, BN statistics)."""
    back = state_dict_to_jax(nets["net"].state_dict(),
                             **net_layout(nets["net"]))

    def leaves(tree, prefix=()):
        for k, x in tree.items():
            if isinstance(x, dict):
                yield from leaves(x, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(x)

    want = dict(leaves(nets["v"]))
    got = dict(leaves(back))
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))


def test_rpn_mode_outputs_and_empty_lists(nets):
    """Mode RPN (the shipped YAML's): the RPN's four outputs within
    ``TOL`` of JAX's, and ``inference_end`` one empty list a sample, as
    in JAX."""
    pts = nets["points"]["dense"]
    jmodel, want = nets["jrpn"], nets["rpn"]["dense"]
    model = PointRCNN(**dict(SMALL, mode="RPN"))
    net = model.get_net().eval()
    net.load_state_dict(nets["net"].state_dict())
    with torch.no_grad():
        got = net({"point": torch.from_numpy(pts)})
    assert set(got) == set(want) == {"cls", "reg", "xyz", "feats"}
    for key in got:
        assert _rel(_np(got[key]), want[key]) <= TOL, key
    assert model.inference_end(got, {}) == \
        jmodel.inference_end(want, {}) == [[], []]


def test_proposal_layer_one_sample_equals_jax(nets):
    """``PointRCNN.proposal_layer`` on one sample's RPN outputs, as the
    JAX method takes them, on the sparse scene (near-equal scores): the
    JAX net's proposals of that sample (its ``_proposals``, which the
    JAX ``proposal_layer`` repeats): the same candidates survive in the
    same order (validity equal), their boxes and scores within ``TOL``
    (XLA fuses the decode)."""
    rpn = nets["rpn"]["sparse"]
    args = (rpn["cls"][1][:, 0], rpn["reg"][1], rpn["xyz"][1])
    want = [nets["want"]["sparse"][k][1] for k in ("rois", "scores",
                                                   "valid")]
    got = nets["model"].proposal_layer(*(torch.from_numpy(a) for a in args))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        g, w = _np(g), np.asarray(w)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        assert _rel(g[fin], w[fin]) <= TOL
    assert got[0].shape == (64, 7) and 0 < int(got[2].sum()) <= 64




# --------------------------------------------------------------- chip_smoke

def test_chip_smoke_config_equals_shipped_yaml():
    """``chip_smoke.POINTRCNN_KITTI`` is the model section of the port's
    ``pointrcnn_kitti.yml`` (and so the JAX package's) but for its name,
    checkpoint and augment section; the pipeline constants are the
    YAML's."""
    for root in ("open3d_ml_tpu_torch", "open3d_ml_tpu"):
        cfg = Config.load_from_file(REPO / root /
                                    "configs/pointrcnn_kitti.yml")
        model = {k: v for k, v in cfg.model.to_dict().items()
                 if k not in ("name", "ckpt_path", "augment")}
        assert chip_smoke.POINTRCNN_KITTI == model
        for key, value in chip_smoke.POINTRCNN_PIPELINE.items():
            assert cfg.pipeline[key] == value, key
    model = chip_smoke.prcnn_model()
    assert model.mode == "RCNN" and model.npoints == 16384
    assert model.rpn_head_cfg.reg_channels == 76
    assert model.rcnn_head_cfg.reg_channels == 46


def test_chip_smoke_launch_constants():
    """A served frame's wrapper calls, counted by ``chip_smoke`` 's own
    capture on a net of the shipped structure (narrowed RCNN stage, fewer
    centres): 14 ``knn_exact``, 6 ``fps``, 1 ``nms_bev`` in the forward
    and 1 more in ``inference_end``, as ``PRCNN_FORWARD_LAUNCHES`` and
    ``PRCNN_SERVE_LAUNCHES`` state."""
    model = PointRCNN(**dict(SMALL, mode="RCNN"))
    net = model.get_net().eval()
    x = {"point": torch.from_numpy(dense_scene(np.random.default_rng(13),
                                               b=1))}
    calls, out = chip_smoke._prcnn_calls(net, x)
    assert {k: len(v) for k, v in calls.items()} == \
        chip_smoke.PRCNN_FORWARD_LAUNCHES
    # the RPN's 4 levels at k = 16 and 32 (the last level's 16 points cut
    # 32 to 16), 4 three-NN, the RCNN's 2 (k = 16 here, 64 at the shipped
    # config)
    assert sorted(args[2] for args, _ in calls["knn_exact"]) == \
        [3] * 4 + [16] * 7 + [32] * 3
    refine = chip_smoke._captured(
        chip_smoke.cnms, "nms_bev", lambda: model.inference_end(out, {}))
    assert len(refine) == chip_smoke.PRCNN_SERVE_LAUNCHES["nms_bev"] - \
        chip_smoke.PRCNN_FORWARD_LAUNCHES["nms_bev"]


def test_chip_smoke_request_draws_without_repeats(tmp_path):
    """``chip_smoke.prcnn_request``'s frame (``prcnn_scene``) holds more
    points than the shipped config draws, out to 70.4 m, so the test
    split's 16,384 are distinct and some lie beyond 40 m, where the
    proposal layer's far bucket takes its candidates."""
    model = chip_smoke.prcnn_model()
    data, frame_points = chip_smoke.prcnn_request(model, tmp_path)
    pts = data["point"][0]
    assert frame_points > model.npoints and pts.shape == (model.npoints, 3)
    assert len(np.unique(pts, axis=0)) == model.npoints
    depth = pts[:, 2]  # the camera frame's z, ahead
    assert 0.2 < (depth > 40.0).mean() < 0.5 and depth.max() <= 71.0


def _trace_boxes():
    """Three boxes in score order, (x, y, w, h, angle): box 1 a shifted
    copy of box 0, box 2 apart from both; and the plain IoU of 0 and 1."""
    boxes = torch.tensor([[[0.0, 0.0, 2.0, 4.0, 0.3],
                           [0.2, 0.1, 2.0, 4.0, 0.3],
                           [9.0, 9.0, 2.0, 4.0, 0.0]]])
    iou = chip_smoke.iou_bev(boxes[0, :1], boxes[0, 1:2])
    return boxes, float(iou[0, 0])


@pytest.mark.parametrize("case", ["plain", "near flip", "far flip",
                                  "invalid kept", "overlap kept"])
def test_chip_smoke_nms_trace(case):
    """``chip_smoke.nms_trace`` holds every keep decision to the plain IoU:
    the plain version's mask passes with no near decision; a decision
    flipped where a kept earlier box's plain IoU equals the threshold is
    counted; one flipped with no such box, an invalid box kept, or a box
    kept over a kept box whose IoU lies above the threshold, raises."""
    boxes, iou01 = _trace_boxes()
    valid = torch.tensor([[True, True, True]])
    thr = iou01 if case == "near flip" else 0.5
    if case == "invalid kept":
        valid[0, 2] = False
    plain = chip_smoke.cnms.nms_bev_plain(boxes, valid, thr)
    keep = {"plain": plain,
            "near flip": torch.tensor([[True, False, True]]),
            "far flip": torch.tensor([[True, True, False]]),
            "invalid kept": torch.tensor([[True, False, True]]),
            "overlap kept": torch.tensor([[True, True, True]])}[case]
    assert iou01 > 0.5
    if case == "plain":
        assert plain.tolist() == [[True, False, True]]
        assert chip_smoke.nms_trace(boxes, valid, thr, keep) == 0
    elif case == "near flip":
        assert plain.tolist() == [[True, True, True]]
        assert chip_smoke.nms_trace(boxes, valid, thr, keep) == 1
    else:
        with pytest.raises(AssertionError, match="no kept box near"):
            chip_smoke.nms_trace(boxes, valid, thr, keep)


@pytest.mark.slow
def test_full_width_net_equals_jax():
    """The shipped config at full width and depth (16,384 points of the
    dense grid scene, SA centres 4,096/1,024/256/64, ``nms_pre`` 9,000,
    512 points a roi): the RPN's outputs within ``TOL`` of the JAX net's
    (its neighbours exact on the grid); the port's proposal layer and
    ``roipool3d`` on JAX's RPN outputs; the RCNN net on 100 rois of 512
    pooled points within ``TOL`` of the JAX RCNN net, but for rois with
    a near tie (``near_tie_rois``, at most ``GENERIC_TIED_SHARE``).
    JAX's own proposal layer is not run: its IoU matrix at 6,300
    candidates needs tens of GB on the CPU (the port's plain version
    runs in row blocks)."""
    cfg = chip_smoke.POINTRCNN_KITTI
    rng = np.random.default_rng(14)
    pts = dense_scene(rng, b=1, n=16384, far=4096)
    jrpn = JaxPointRCNN(**dict(cfg, mode="RPN"))
    jrcnn = jrpn.get_rcnn_net()
    rpn_v = jax_variables(jrpn.get_net(), {"point": pts}, training=False)
    pooled_shape = (512, 5 + 128)
    rcnn_v = jax_variables(jrcnn, np.zeros(pooled_shape, np.float32),
                           seed=1)
    v = {c: {"rpn": rpn_v[c]["rpn"], "rcnn": rcnn_v[c]}
         for c in ("params", "batch_stats")}
    want = jax.tree.map(np.asarray, jax.jit(lambda p: jrpn.get_net().apply(
        v, {"point": p}, training=False))(pts))
    model = PointRCNN(**dict(cfg, mode="RCNN"))
    net = load_jax_variables(model.get_net(), v).eval()
    with torch.no_grad():
        got = net.rpn(torch.from_numpy(pts))
        for g, key in zip(got, ("cls", "reg", "xyz", "feats")):
            assert _rel(_np(g), want[key]) <= TOL, key
        cls, reg, xyz, feats = (torch.from_numpy(want[k]) for k in
                                ("cls", "reg", "xyz", "feats"))
        rois, _, valid = net.proposals(cls, reg, xyz)
        pooled = net.pool(cls, xyz, feats, rois)
    assert rois.shape == (1, 100, 7) and valid.any()
    assert pooled.shape == (1, 100, 512, 133)
    # the RCNN nets on pooled points of the same shape off the grid (the
    # grid's equal distances stay equal but for rounding once rotated
    # into a roi's frame, which flags nearly every roi here)
    pts_input = np.concatenate(
        [rng.uniform(-3, 3, (100, 512, 3)),
         rng.integers(0, 2, (100, 512, 1)), rng.uniform(-0.5, 0.5,
                                                        (100, 512, 1)),
         rng.normal(0, 1, (100, 512, 128))], -1).astype(np.float32)
    with torch.no_grad():
        rcls, rreg = net.rcnn(torch.from_numpy(pts_input))
    wcls, wreg = jax.jit(jax.vmap(lambda x: jrcnn.apply(
        {c: v[c]["rcnn"] for c in v}, x, training=False)))(pts_input)
    ok = ~near_tie_rois(net, torch.from_numpy(pts_input)[None])[0]
    assert ok.mean() >= 1 - GENERIC_TIED_SHARE
    assert _rel(_np(rcls)[ok], np.asarray(wcls)[ok]) <= TOL
    assert _rel(_np(rreg)[ok], np.asarray(wreg)[ok]) <= TOL
