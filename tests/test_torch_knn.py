"""The port's exact k-NN (``open3d_ml_tpu_torch/ops/neighbors.py`` over
``ops/cuda/knn.py``) against the JAX package.

The JAX side runs as its own tests run it on the CPU: the Pallas kernel
``knn_pallas`` in interpret mode, and ``knn_search``'s XLA route. The port's
wrapper takes its plain version for CPU tensors.

Two kinds of input. On a 1/32 lattice in [-4, 4)^3 every form of d2 is
exact in float32, so both sides see the same distances, ties included, and
must agree index for index: that tests the tie order (lower index first).
On uniform floats in +-25, |q|^2 reaches ~1,900 and the cross-term formula
rounds at the scale of the gaps between neighbours, differently in each
implementation's summation order; there the chosen neighbours' distances,
recomputed in float64, must agree within 1e-3, and the sets may differ
only at near-ties.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from open3d_ml_tpu.ops import neighbors as jn
from open3d_ml_tpu.ops.pallas.knn import knn_pallas
from open3d_ml_tpu_torch.ops import neighbors as tn
from open3d_ml_tpu_torch.ops.cuda import knn as ck

from test_torch_ops import lattice_cloud

N, K = 700, 16  # N is a multiple of no tile of either implementation
NEAR = 1e-3  # float64 distance gap inside which two neighbours may swap


def _jax(fn, points, queries, k, mask=None, **kw):
    mask = None if mask is None else jnp.asarray(mask)
    idx, d2 = fn(jnp.asarray(points), jnp.asarray(queries), k,
                 points_mask=mask, **kw)
    return np.asarray(idx), np.asarray(d2)


def _port(points, queries, k, mask=None):
    mask = None if mask is None else torch.from_numpy(mask)
    idx, d2 = tn.knn_search(torch.from_numpy(points),
                            torch.from_numpy(queries), k, points_mask=mask)
    return idx.numpy(), d2.numpy()


REFERENCES = {
    "pallas": lambda *a, **kw: _jax(knn_pallas, *a, interpret=True, **kw),
    "xla": lambda *a, **kw: _jax(jn.knn_search, *a, **kw),
}


def _d64(points, queries, idx):
    diff = (queries[:, None, :].astype(np.float64) -
            points[idx].astype(np.float64))
    return (diff * diff).sum(-1)


@pytest.mark.parametrize("ref", sorted(REFERENCES))
def test_lattice_equal_index_for_index(ref):
    pts = lattice_cloud(np.random.default_rng(0), 1, N)[0]
    idx, d2 = _port(pts, pts, K)
    ridx, rd2 = REFERENCES[ref](pts, pts, K)
    assert idx.shape == (N, K) and idx.dtype == np.int32
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(d2, rd2)
    assert (idx[:, 0] == np.arange(N)).all()
    # the lattice has ties, and they came out lower index first
    tied = d2[:, 1:] == d2[:, :-1]
    assert tied.any() and (idx[:, 1:][tied] > idx[:, :-1][tied]).all()


@pytest.mark.parametrize("ref", sorted(REFERENCES))
def test_uniform_floats_agree_off_near_ties(ref):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-25, 25, (N, 3)).astype(np.float32)
    qs = np.concatenate([pts[:300], rng.uniform(-25, 25, (200, 3))
                         .astype(np.float32)])
    idx, d2 = _port(pts, qs, K)
    ridx, _ = REFERENCES[ref](pts, qs, K)
    got, want = _d64(pts, qs, idx), _d64(pts, qs, ridx)
    np.testing.assert_allclose(np.sort(got, 1), np.sort(want, 1), rtol=0,
                               atol=NEAR)
    # a neighbour only one side chose lies within NEAR of the k-th distance
    kth = np.maximum(got.max(1), want.max(1))
    for row in range(len(qs)):
        only = set(idx[row]) ^ set(ridx[row])
        for i in only:
            d = _d64(pts, qs[row:row + 1], np.array([[i]]))[0, 0]
            assert abs(d - kth[row]) <= NEAR, (row, i)
    # the returned d2 is the formula's, close to the float64 distance
    assert np.abs(d2 - got).max() <= NEAR


@pytest.mark.parametrize("ref", sorted(REFERENCES))
def test_points_mask(ref):
    rng = np.random.default_rng(2)
    pts = lattice_cloud(rng, 1, N)[0]
    mask = rng.random(N) < 0.7
    idx, _ = _port(pts, pts[:200], K, mask)
    ridx, _ = REFERENCES[ref](pts, pts[:200], K, mask)
    np.testing.assert_array_equal(idx, ridx)
    assert mask[idx].all()


def test_nearest_is_argmin_lower_index_first():
    """k = 1 takes the chunked minimum, as the JAX package's argmin."""
    pts = lattice_cloud(np.random.default_rng(3), 1, N)[0]
    sub = np.concatenate([pts[:150], pts[:20]])  # duplicates: exact ties
    idx, d2 = _port(sub, pts, 1)
    ridx, rd2 = REFERENCES["xla"](sub, pts, 1)
    assert idx.shape == (N, 1)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(d2, rd2)
    assert (idx[:150, 0] == np.arange(150)).all()


def test_nearest_with_mask():
    rng = np.random.default_rng(4)
    pts = lattice_cloud(rng, 1, N)[0]
    mask = rng.random(N) < 0.5
    idx, _ = _port(pts, pts, 1, mask)
    ridx, _ = REFERENCES["xla"](pts, pts, 1, mask)
    np.testing.assert_array_equal(idx, ridx)
    assert mask[idx].all()


def test_k_above_n_is_cut_to_n():
    pts = lattice_cloud(np.random.default_rng(5), 1, 10)[0]
    idx, d2 = _port(pts, pts, K)
    ridx, rd2 = REFERENCES["xla"](pts, pts, K)
    assert idx.shape == (10, 10)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(d2, rd2)


def test_batch_equals_each_sample():
    clouds = torch.from_numpy(lattice_cloud(np.random.default_rng(6), 3, 300))
    for k in (1, K):
        idx, d2 = tn.knn_search(clouds, clouds, k)
        for b in range(3):
            one = tn.knn_search(clouds[b], clouds[b], k)
            assert torch.equal(idx[b], one[0]) and torch.equal(d2[b], one[1])


def test_plain_chunks_agree(monkeypatch):
    """Query blocks of one row and of all rows give the same result."""
    pts = torch.from_numpy(lattice_cloud(np.random.default_rng(7), 2, 200))
    whole = ck.knn_exact_plain(pts, pts, K)
    monkeypatch.setattr(ck, "CHUNK_ELEMS", 1)
    rows = ck.knn_exact_plain(pts, pts, K)
    assert all(torch.equal(a, b) for a, b in zip(whole, rows))


def test_wrapper_checks():
    pts = torch.zeros((1, 20, 3))
    with pytest.raises(ValueError, match="float32"):
        ck.knn_exact(pts.double(), pts.double(), K)
    with pytest.raises(ValueError, match="k <= N"):
        ck.knn_exact(pts, pts, 21)
    with pytest.raises(ValueError, match="points_mask"):
        ck.knn_exact(pts, pts, K,
                     points_mask=torch.ones((1, 19), dtype=torch.bool))
    with pytest.raises(ValueError, match="queries"):
        ck.knn_exact(pts, torch.zeros((2, 20, 3)), K)
    meta = torch.zeros((1, 20, 3), device="meta")
    with pytest.raises(ValueError, match="no knn_exact kernel"):
        ck.knn_exact(meta, meta, K)
    with pytest.raises(NotImplementedError, match="3-d"):
        tn.knn_search(torch.zeros((20, 4)), torch.zeros((5, 4)), K)


@pytest.mark.parametrize("batched", [False, True])
def test_pyramid_equal_to_jax(batched):
    """Every level's neighbour, pool and upsample indices equal the JAX
    exact pyramid's, on lattice clouds."""
    clouds = lattice_cloud(np.random.default_rng(8), 2, 1024)
    ratios = [4, 4, 4, 4]
    got = tn.build_knn_pyramid(torch.from_numpy(clouds if batched
                                                else clouds[0]), K, ratios)
    for b in range(2 if batched else 1):
        want = jn.build_knn_pyramid(jnp.asarray(clouds[b]), K, ratios)
        for key in ("coords", "neighbor_indices", "sub_idx", "interp_idx"):
            assert len(got[key]) == len(ratios)
            for level, ref in enumerate(want[key]):
                port = got[key][level]
                port = (port[b] if batched else port).numpy()
                np.testing.assert_array_equal(port, np.asarray(ref),
                                              err_msg=f"{key} {level}")


@pytest.mark.parametrize("method", ["approx", "grid", "window"])
def test_pyramid_rejects_unported_methods(method):
    with pytest.raises(NotImplementedError, match=method):
        tn.build_knn_pyramid(torch.zeros((64, 3)), K, [4], method=method)
