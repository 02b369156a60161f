"""The port's rotated-BEV NMS (``open3d_ml_tpu_torch/ops/nms.py`` and
``ops/cuda/nms.py``) against the JAX package's ``nms_bev``, on the CPU,
and the kernel's launch path through a stand-in library.

Tolerances, each with its reason:

* The keep masks are equal, but for boxes whose JAX IoU with another box
  lies within ``IOU_NEAR`` of the threshold (the 24-candidate sums round
  apart), and at most ``NMS_FLIPS`` boxes of a call may differ (0
  measured on random and edge-sharing boxes).
* The IoU matrices agree within 1e-4 but for coincident and edge-sharing
  pairs, where the algorithm's ``_EPS`` is below float32's resolution
  (``test_coincident_box_iou_fault``); the greedy pass is held exactly
  by replaying JAX's IoU matrix through the port's.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open3d_ml_tpu.ops.iou import iou_bev as jax_iou_bev
from open3d_ml_tpu.ops.nms import nms_bev as jax_nms_bev
from open3d_ml_tpu_torch.ops.cuda import nms as cnms
from open3d_ml_tpu_torch.ops.iou import iou_bev
from open3d_ml_tpu_torch.ops.nms import nms_bev
from torch_threads import one_torch_thread  # noqa: F401

IOU_NEAR = 1e-6
NMS_FLIPS = 4  # boxes of a 1,024-box call, at most


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)



def _boxes(rng, n, kind):
    """[n, 5] BEV boxes drawn to overlap: random centres in a 20 m square
    (every box meets several), identical boxes, and boxes sharing an
    edge with the box before them."""
    c = rng.uniform(0, 20, (n, 2))
    wh = rng.uniform(1.0, 4.0, (n, 2))
    a = rng.uniform(-np.pi, np.pi, (n, 1))
    boxes = np.concatenate([c, wh, a], 1)
    if kind == "identical":
        boxes[1::2] = boxes[0::2]
    elif kind == "edge":
        boxes[1::2, 4] = boxes[0::2, 4]
        boxes[1::2, 3] = boxes[0::2, 3]
        off = boxes[0::2, 2]  # along the box's own x axis, one width on
        boxes[1::2, 0] = boxes[0::2, 0] + off * np.cos(boxes[0::2, 4])
        boxes[1::2, 1] = boxes[0::2, 1] + off * np.sin(boxes[0::2, 4])
        boxes[1::2, 2] = boxes[0::2, 2]
    return boxes.astype(np.float32)


THRESHOLDS = (0.1, 0.8)
# boxes of each kind: the random ones at the size of a proposal bucket's
# scale of test, the coincident and edge-sharing ones fewer
SIZES = {"random": 1024, "identical": 256, "edge": 256}


@functools.lru_cache(maxsize=None)
def _case(kind, seed=5):
    """``SIZES[kind]`` boxes of ``kind``, scores with ties, a valid mask,
    both packages' IoU matrices (the port's in blocks of 64 rows) and
    JAX's keep masks at ``THRESHOLDS``."""
    n = SIZES[kind]
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, n, kind)
    scores = np.round(rng.uniform(0, 1, n), 2).astype(np.float32)  # ties
    valid = rng.random(n) < 0.9
    iou = np.asarray(jax.jit(lambda b: jax_iou_bev(b, b, xp=jnp))(boxes))
    t = torch.from_numpy(boxes)
    port = np.concatenate([_np(iou_bev(t[s:s + 64], t))
                           for s in range(0, n, 64)])
    # both thresholds in one call: the IoU matrix does not depend on them
    b, sc, v = (jnp.asarray(a) for a in (boxes, scores, valid))
    keeps = np.asarray(jax.jit(jax.vmap(
        lambda thr: jax_nms_bev(b, sc, thr, valid_mask=v)))(
            np.asarray(THRESHOLDS, np.float32)))
    return boxes, scores, valid, iou, port, dict(zip(THRESHOLDS, keeps))


def _port_keep(scores, valid, iou, thr):
    """The port's NMS on an IoU matrix: ``ops/nms.py``'s stable score
    sort, the suppression of later boxes above ``thr``, ``greedy_plain``,
    and the keep mask back in box order (``nms_bev_plain`` with its IoU
    blocks computed ahead: ``test_nms_bev_end_to_end`` holds the two
    equal)."""
    order = torch.sort(-torch.from_numpy(scores), stable=True).indices
    o = order.numpy()
    suppress = torch.from_numpy(iou[np.ix_(o, o)] > np.float32(thr)) & \
        torch.ones((len(o),) * 2, dtype=torch.bool).triu(1)
    keep = cnms.greedy_plain(suppress[None],
                             torch.from_numpy(valid)[order][None])[0]
    return _np(torch.zeros_like(keep).scatter_(0, order, keep))


@pytest.mark.parametrize("kind", ["random", "identical", "edge"])
@pytest.mark.parametrize("thr", THRESHOLDS)
def test_nms_bev_plain_equals_jax(kind, thr):
    """The port's NMS (score sort, then ``nms_bev_plain``) against JAX's
    ``nms_bev`` on boxes with tied scores and invalid boxes: 1,024 random
    ones, 256 coincident in pairs, 256 sharing an edge in pairs.

    Replayed: the port's sort and greedy pass on JAX's IoU matrix give
    JAX's keep mask exactly. Whole, on the port's own IoU matrix: on
    random and edge-sharing boxes the same keep mask but for boxes whose
    JAX IoU with another lies within ``IOU_NEAR`` of the threshold (at
    most ``NMS_FLIPS``); the IoUs themselves agree within 1e-4 but for
    coincident and edge-sharing boxes, where the rounding fault lies
    (``test_coincident_box_iou_fault``), so the identical kind is held
    by the replay alone."""
    boxes, scores, valid, iou, port_iou, keeps = _case(kind)
    want = keeps[thr]
    np.testing.assert_array_equal(_port_keep(scores, valid, iou, thr),
                                  want)
    got = _port_keep(scores, valid, port_iou, thr)
    assert got.dtype == bool and 0 < got.sum() < valid.sum()
    assert not (got & ~valid).any()
    coincident, touching = _fault_pairs(boxes, kind)
    fault = coincident | touching
    assert (np.abs(port_iou - iou)[~fault] <= 1e-4).all()
    if kind != "identical":
        flips = np.flatnonzero(got != want)
        assert len(flips) <= NMS_FLIPS
        assert all((np.abs(iou[f] - thr) <= IOU_NEAR).any() for f in flips)


def _fault_pairs(boxes, kind):
    """(coincident, touching) [N, N] bool: the pairs of equal boxes, and
    in the edge kind each pair (2k, 2k + 1) that shares an edge."""
    coincident = (boxes[:, None] == boxes[None]).all(-1)
    touching = np.zeros_like(coincident)
    if kind == "edge":
        i = np.arange(0, len(boxes) - 1, 2)
        touching[i, i + 1] = touching[i + 1, i] = True
    return coincident, touching & ~coincident


def test_coincident_box_iou_fault():
    """A fault of the rotated IoU, pinned in both packages. ``_EPS``
    (1e-8) is below float32's resolution at a box's scale, so whether a
    corner lying on the other box's edge passes the inside test, and a
    corner intersection the on-edge test, is decided by rounding.

    In unfused IEEE arithmetic a box whose corners both roles compute
    alike finds each of its corners with itself through the corner
    intersections (t = den / den = 1 and s = 0 exactly), so its IoU with
    itself is 1: so on every one of these boxes, each against itself
    alone, and so in the kernel and torch's CUDA operators, which compute
    a box's corners alike in both roles. XLA's fused arithmetic on the
    CPU breaks those identities: JAX gives a box an IoU below 0.5 with
    itself (72 of these 1,024), and keeps slivers of boxes that only
    share an edge (true IoU 0; here 3 of 128 pairs, up to 0.076, above
    the 0.01 threshold of PointPillars' decode; 27 of 512 pairs, up to
    0.17, among 1,024 such boxes). torch's CPU operators take a
    vectorised and a scalar path for cos and sin, which can round a
    box's angle apart in its two roles: in the whole matrix, 1 of the
    1,024 boxes (none of these 256 pairs keeps a sliver). ROADMAP queue
    3."""
    boxes, _, _, iou, port, _ = _case("random")
    assert (np.diag(iou) < 0.5).sum() > 10
    assert (np.diag(port) < 0.999).sum() <= 2
    t = torch.from_numpy(boxes)[:, None]
    np.testing.assert_allclose(_np(iou_bev(t, t))[:, 0, 0], 1.0, atol=1e-4)
    boxes, _, _, iou, port, _ = _case("edge")
    _, touching = _fault_pairs(boxes, "edge")
    assert iou[touching].max() > 0.01
    assert (port[touching] > 1e-3).sum() < (iou[touching] > 1e-3).sum()


def test_nms_bev_end_to_end():
    """``ops/nms.py`` ``nms_bev`` on the CPU (the sort, ``nms_bev_plain``
    with its IoU matrix in row blocks) gives the keep mask of the port's
    own IoU matrix through the same sort and greedy pass, on 256 random
    boxes at both thresholds."""
    rng = np.random.default_rng(15)
    boxes = _boxes(rng, 256, "random")
    scores = np.round(rng.uniform(0, 1, 256), 2).astype(np.float32)
    valid = rng.random(256) < 0.9
    t = torch.from_numpy(boxes)
    port_iou = _np(iou_bev(t, t))
    for thr in THRESHOLDS:
        got = _np(nms_bev(torch.from_numpy(boxes), torch.from_numpy(scores),
                          thr, valid_mask=torch.from_numpy(valid)))
        np.testing.assert_array_equal(
            got, _port_keep(scores, valid, port_iou, thr))


def test_nms_bev_suppression_chain_and_batch():
    """A chain a > b > c where a suppresses b and b would suppress c: c
    survives; rows of a batch are independent; the plain version's IoU
    blocks cover every pair (the mask equals one whole-matrix pass)."""
    box = [0.0, 0.0, 4.0, 2.0, 0.0]
    boxes = torch.tensor([box, [0.5, 0, 4, 2, 0], [1.0, 0, 4, 2, 0]])
    scores = torch.tensor([0.9, 0.8, 0.7])
    keep = nms_bev(boxes, scores, 0.7)
    assert keep.tolist() == [True, False, True]
    batch = nms_bev(torch.stack([boxes, boxes.flip(0)]),
                    torch.stack([scores, scores]), 0.7)
    assert batch[0].tolist() == [True, False, True]
    assert batch[1].tolist() == [True, False, True]
    rng = np.random.default_rng(6)
    b = torch.from_numpy(_boxes(rng, 300, "random"))[None]
    whole = (iou_bev(b, b) > 0.3) & torch.ones((300, 300), dtype=torch.bool
                                               ).triu(1)
    assert torch.equal(cnms.suppression_plain(b, 0.3), whole)


def test_nms_bev_kernel_route(monkeypatch):
    """On the kernel route the wrapper hands its entry point the sorted
    boxes, the valid mask, a [R, N, ceil(N / 64) + 1] int64 mask scratch
    (the last word a box's column word of its own block), the
    threshold and both kernels (``MASK | SWEEP``); one launch a call;
    PointPillars' [B, classes] rows and the proposal layer's two padded
    buckets each take one call; ``launch`` runs either kernel alone on a
    scratch it is given; rows past ``MAX_BOXES`` (the sweep's bits in
    46 KB of shared memory) are refused."""
    from open3d_ml_tpu_torch.ops.cuda import _build
    calls = []

    class Library:
        def nms_bev_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(cnms, "route", lambda t, family: "kernel")
    monkeypatch.setattr(cnms, "stream", lambda: 0)
    monkeypatch.setattr(cnms, "LAUNCHES", {"nms_bev": 0})
    scratch = []
    real = cnms.scratch
    monkeypatch.setattr(cnms, "scratch", lambda *a: scratch.append(
        real(*a)) or scratch[-1])
    boxes = torch.zeros((2, 3, 100, 5))
    nms_bev(boxes, torch.zeros((2, 3, 100)), 0.01)
    args = calls[-1]
    # boxes, valid, mask, keep, R, N, threshold, stages, stream
    assert args[4:] == (6, 100, 0.01, cnms.MASK | cnms.SWEEP, 0)
    assert scratch[-1].shape == (6, 100, 3) and \
        scratch[-1].dtype == torch.int64
    assert args[2] == scratch[-1].data_ptr()
    assert cnms.LAUNCHES == {"nms_bev": 1}
    b, v = torch.zeros((2, 6300, 5)), torch.ones((2, 6300), dtype=torch.bool)
    mask = real(2, 6300, b.device)
    assert mask.shape == (2, 6300, 100)
    cnms.launch(b, v, 0.85, mask, cnms.MASK)
    cnms.launch(b, v, 0.85, mask, cnms.SWEEP)
    assert [c[7] for c in calls[-2:]] == [cnms.MASK, cnms.SWEEP]
    assert all(c[2] == mask.data_ptr() for c in calls[-2:])
    assert cnms.LAUNCHES == {"nms_bev": 1}  # launch alone counts nothing
    with pytest.raises(ValueError, match="mask scratch"):
        cnms.launch(b, v, 0.85, real(2, 6299, b.device), cnms.MASK)
    assert cnms.MAX_BOXES == 376_832
    n = cnms.MAX_BOXES + 1
    with pytest.raises(ValueError, match="N <= 376832"):
        cnms.launch(torch.zeros((1, n, 5)),
                    torch.ones((1, n), dtype=torch.bool), 0.5,
                    torch.empty((1, 1, 1), dtype=torch.int64), cnms.MASK)
    with pytest.raises(ValueError, match="contiguous"):
        cnms.nms_bev(torch.zeros((1, 5, 100)).transpose(1, 2),
                     torch.ones((1, 100), dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="boxes \\[R, N, 5\\]"):
        cnms.nms_bev(torch.zeros((1, 100, 4)),
                     torch.ones((1, 100), dtype=torch.bool), 0.5)
    assert cnms.LAUNCHES == {"nms_bev": 1}
