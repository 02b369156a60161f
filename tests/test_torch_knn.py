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


# ----------------------------------------------- the kernel's slices and plan

def _keys(d2, index):
    """int64 (d2 bits, index) keys: ascending d2, the lower index first."""
    return (d2.view(torch.int32).long() << 32) | index


def _best(d2, index, k):
    """The k best (d2, index) of each row, ascending by key, padded with
    (inf, 0) where a row has fewer than k."""
    key = _keys(d2, index)
    pad = k - key.shape[-1]
    if pad > 0:
        fill = _keys(torch.tensor(float("inf")), torch.tensor(0))
        key = torch.cat([key, fill.expand(*key.shape[:-1], pad)], -1)
    top = torch.topk(key, k, dim=-1, largest=False).values
    return (top >> 32).int().view(torch.float32), (top & 0xFFFFFFFF).int()


def _merge(lists, k):
    """Merge (d2, index) lists by key, keeping the k best."""
    return _best(torch.cat([d for d, _ in lists], -1),
                 torch.cat([i for _, i in lists], -1).long(), k)


def _slices(n, count, strided):
    index = torch.arange(n)
    return ([index[p::count] for p in range(count)] if strided else
            list(torch.tensor_split(index, count)))


def _split_and_merge(points, queries, k, mask, count, strided):
    """Each slice's k best by (d2, index) from the contract's d2, then the
    slices' lists merged by key: what the kernel's merges compute."""
    pn = ck.masked_norms(points, mask)
    d2 = ck.pairwise_d2(queries, ck.sq_norms(queries), points, pn)
    lists = [_best(d2[..., sl], sl, k)
             for sl in _slices(points.shape[1], count, strided)]
    d, i = _merge(lists, k)
    return i, d


def _insert(ld, li, x, xi, ok):
    """The kernel's insert on [Q, K] lists: x goes after every entry of
    equal d2 where ok and x < the last entry."""
    ok = ok & (x < ld[:, -1])
    pos = (ld <= x[:, None]).sum(1, keepdim=True)
    j = torch.arange(ld.shape[1])
    sd = torch.cat([ld[:, :1], ld[:, :-1]], 1)
    si = torch.cat([li[:, :1], li[:, :-1]], 1)
    nd = torch.where(j < pos, ld, torch.where(j == pos, x[:, None], sd))
    ni = torch.where(j < pos, li, torch.where(j == pos, xi, si))
    return (torch.where(ok[:, None], nd, ld),
            torch.where(ok[:, None], ni, li))


def _warp_chunks(plan, n):
    """The candidates [a, b) of each tile, warp by warp, as the kernel
    walks them: tiles of warps * chunk."""
    ch = plan["chunk"]
    return [[(min(n, start + w * ch), min(n, start + (w + 1) * ch))
             for w in range(plan["warps"])]
            for start in range(0, n, plan["warps"] * ch)]


def _emulate_exact(points, queries, mask, plan, k=K):
    """``knn_exact``'s kernel on one sample as its plan runs it: a block
    scans the candidates in tiles (``_warp_chunks``), each warp keeping its
    own list: its first k candidates seed it, the rest go through the
    strict insert; after each tile the warps' bound (the least of their
    k-th best and the largest of their ceil(k / warps)-th best) filters
    every later insert (d2 <= bound); the warps' lists merge by key."""
    pn = ck.masked_norms(points, mask)[0]
    qs = queries[0]
    d2 = ck.pairwise_d2(qs[None], ck.sq_norms(qs)[None], points, pn[None])[0]
    n, nq = points.shape[1], qs.shape[0]
    nw = plan["warps"]
    jpost = -(-k // nw) - 1
    ld = torch.full((nw, nq, k), float("inf"))
    li = torch.zeros((nw, nq, k), dtype=torch.int64)
    bound = torch.full((nq,), float("inf"))
    seeded = [False] * nw
    for tile in _warp_chunks(plan, n):
        for w, (a, b) in enumerate(tile):
            for c in range(a, b):
                seed = not seeded[w] and c < a + k
                ok = torch.full((nq,), True) if seed else d2[:, c] <= bound
                ld[w], li[w] = _insert(ld[w], li[w], d2[:, c],
                                       torch.tensor(c), ok)
            seeded[w] = seeded[w] or b > a
        if nw > 1:
            bound = torch.minimum(ld[:, :, -1].min(0).values,
                                  ld[:, :, jpost].max(0).values)
    d, i = _merge([(ld[w], li[w]) for w in range(nw)], k)
    return i[None], d[None]


def _cases():
    """(name, points [B, N, 3], queries, mask): lattice points, whose d2
    repeat many times; uniform floats; and a mask that leaves one sample
    fewer than K valid points."""
    rng = np.random.default_rng(30)
    lat = torch.from_numpy(lattice_cloud(rng, 2, 300))
    uni = torch.from_numpy(rng.uniform(-25, 25, (2, 300, 3))
                           .astype(np.float32))
    mask = torch.from_numpy(rng.random((2, 300)) < 0.6)
    mask[1] = False
    mask[1, rng.choice(300, 5, replace=False)] = True
    return [("lattice", lat, lat[:, :120], None),
            ("uniform", uni, uni[:, :120], None),
            ("masked", lat, lat[:, :120], mask)]


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("count", [1, 3, 8, 32])
@pytest.mark.parametrize("case", ["lattice", "uniform", "masked"])
def test_slices_merged_by_key_equal_the_plain_version(case, count, strided):
    """However the candidates are split (contiguous or strided slices),
    each slice's k best by (d2, index) merged by the same key equal
    ``knn_exact_plain`` index for index, ties and masked points (which
    come after the valid ones, in index order) included."""
    _, pts, qs, mask = next(c for c in _cases() if c[0] == case)
    want = ck.knn_exact_plain(pts, qs, K, points_mask=mask)
    got = _split_and_merge(pts, qs, K, mask, count, strided)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if mask is not None:
        valid = mask[1][want[0][1].long()]
        assert valid[:, :5].all() and not valid[:, 5:].any()


@pytest.mark.parametrize("n", [300, 1200])
@pytest.mark.parametrize("case", ["lattice", "uniform", "masked"])
def test_kernel_emulation_equals_the_plain_version(case, n):
    """The kernel's algorithm, emulated with its plan for 132 SMs and for
    plans of more warps and smaller chunks, equals the plain version on
    each sample: the bound the warps share never drops a candidate the
    answer needs."""
    _, pts, _, mask = next(c for c in _cases() if c[0] == case)
    if n > pts.shape[1]:
        reps = -(-n // pts.shape[1])
        pts = (pts.repeat(1, reps, 1)[:, :n] +
               torch.arange(n)[None, :, None] // pts.shape[1] * 8.0)
        mask = None if mask is None else mask.repeat(1, reps)[:, :n]
    qs = pts[:, ::5].contiguous()
    plans = [ck.exact_plan(1, n, qs.shape[1], sms=132),
             {"warps": 8, "chunk": 32}, {"warps": 4, "chunk": 64}]
    for b in range(pts.shape[0]):
        m = None if mask is None else mask[b:b + 1]
        want = ck.knn_exact_plain(pts[b:b + 1], qs[b:b + 1], K, points_mask=m)
        for plan in plans:
            got = _emulate_exact(pts[b:b + 1], qs[b:b + 1], m, plan)
            assert torch.equal(got[0], want[0]), plan
            assert torch.equal(got[1], want[1]), plan


EVAL_LEVELS = (45_056, 11_264, 2_816, 704)  # the shipped eval pyramid


@pytest.mark.parametrize("n", EVAL_LEVELS)
def test_exact_plan_slices_cover_each_candidate_once(n):
    """At every level of the eval pyramid (one sample, queries = points)
    the plan's slices, tile by tile and warp by warp as the kernel walks
    them, cover every candidate exactly once, each warp's in index order;
    the warps stay within 12 an SM of 132, and the small levels, whose
    query groups leave SMs idle, take the most warps a block."""
    plan = ck.exact_plan(1, n, n, sms=132)
    qgroups = -(-n // (32 * plan["qpt"]))
    nw, chunk = plan["warps"], plan["chunk"]
    assert nw in (1, 2, 4, 8) and chunk % 32 == 0 and 32 <= chunk <= 128
    assert qgroups * nw <= ck.WARPS_PER_SM * 132
    tiles = _warp_chunks(plan, n)
    seen = []
    for w in range(nw):
        mine = [c for tile in tiles for c in range(*tile[w])]
        assert mine == sorted(mine)
        seen += mine
    assert sorted(seen) == list(range(n))
    assert [(p["qpt"], p["warps"]) for p in (
        ck.exact_plan(1, m, m, sms=132) for m in EVAL_LEVELS)] == [
            (2, 2), (1, 4), (1, 8), (1, 8)]


def test_knn_exact_wrapper_passes_the_plan(monkeypatch):
    """On the kernel route ``knn_exact`` hands its entry point the plan
    (queries a thread, warps, chunk); one launch per call."""
    from open3d_ml_tpu_torch.ops.cuda import _build
    calls = []

    class Library:
        def knn_exact_launch(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(ck, "route", lambda t, family: "kernel")
    monkeypatch.setattr(ck, "stream", lambda: 0)
    monkeypatch.setattr(ck, "sm_count", lambda index: 132)
    monkeypatch.setattr(ck, "LAUNCHES", {"knn_exact": 0})
    for n in (704, 11_264):
        pts = torch.zeros((1, n, 3))
        mask = torch.ones((1, n), dtype=torch.bool)
        ck.knn_exact(pts, pts, K, points_mask=mask)
        plan = ck.exact_plan(1, n, n, sms=132)
        args = calls[-1]
        # points, queries, mask, idx, d2, B, N, Q, k, qpt, warps, chunk,
        # shared, stream
        assert args[2] == mask.data_ptr()
        assert args[5:] == (1, n, n, K, plan["qpt"], plan["warps"],
                            plan["chunk"], plan["shared"], 0)
    assert ck.LAUNCHES == {"knn_exact": 2}
    # PointTransformer's k: each launches with its own list's plan
    for k in (3, 8):
        idx, d2 = ck.knn_exact(torch.zeros((2, 4096, 3)),
                               torch.zeros((2, 16384, 3)), k)
        assert idx.shape == d2.shape == (2, 16384, k)
        plan = ck.exact_plan(2, 4096, 16384, sms=132, k=k)
        assert calls[-1][5:] == (2, 4096, 16384, k, plan["qpt"],
                                 plan["warps"], plan["chunk"],
                                 plan["shared"], 0)
    assert ck.LAUNCHES == {"knn_exact": 4}
    # PointRCNN's ball queries: lists of 32 and 64, one query a thread
    for b, n, q, k in ((1, 16384, 4096, 32), (100, 512, 128, 64)):
        idx, d2 = ck.knn_exact(torch.zeros((b, n, 3)),
                               torch.zeros((b, q, 3)), k)
        assert idx.shape == d2.shape == (b, q, k)
        plan = ck.exact_plan(b, n, q, sms=132, k=k)
        assert plan["qpt"] == 1 and plan["list"] == k
        assert calls[-1][5:] == (b, n, q, k, 1, plan["warps"],
                                 plan["chunk"], plan["shared"], 0)
    assert ck.LAUNCHES == {"knn_exact": 6}
    for k in (1, 2, 5, 12, 48, 128):
        with pytest.raises(ValueError, match=r"k in \(3, 8, 16, 32, 64\)"):
            ck.knn_exact(torch.zeros((1, 128, 3)),
                         torch.zeros((1, 64, 3)), k)
    assert ck.LAUNCHES == {"knn_exact": 6}


# ---------------------------------------- PointTransformer's k = 3 and 8

@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("ref", sorted(REFERENCES))
def test_lattice_equal_index_for_index_at_pt_k(ref, k):
    """The plain version at PointTransformer's other k against both JAX
    references, index for index on lattice points (ties lower index
    first), queries the sampled points and their duplicates, with and
    without a mask."""
    rng = np.random.default_rng(50)
    pts = lattice_cloud(rng, 1, N)[0]
    pts[600:] = pts[rng.choice(600, N - 600)]  # a patch padded by repeats
    qs = np.ascontiguousarray(pts[::4])
    mask = rng.random(N) < 0.7
    for m in (None, mask):
        idx, d2 = _port(pts, qs, k, m)
        ridx, rd2 = REFERENCES[ref](pts, qs, k, m)
        assert idx.shape == (len(qs), k)
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_array_equal(d2, rd2)
    tied = d2[:, 1:] == d2[:, :-1]
    assert tied.any() and (idx[:, 1:][tied] > idx[:, :-1][tied]).all()


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("case", ["lattice", "uniform", "masked"])
def test_kernel_emulation_short_lists(case, k):
    """The kernel at k = 3 and 8 keeps lists of ``list_len(k)`` (4 and 8)
    entries; its first k, emulated with the plan for k, equal the plain
    version at k."""
    _, pts, _, mask = next(c for c in _cases() if c[0] == case)
    qs = pts[:, ::5].contiguous()
    n = pts.shape[1]
    plan = ck.exact_plan(1, n, qs.shape[1], sms=132, k=k)
    kl = plan["list"]
    assert kl == {3: 4, 8: 8}[k]
    for b in range(pts.shape[0]):
        m = None if mask is None else mask[b:b + 1]
        want = ck.knn_exact_plain(pts[b:b + 1], qs[b:b + 1], k, points_mask=m)
        for p in (plan, {"warps": 8, "chunk": 32}):
            got = _emulate_exact(pts[b:b + 1], qs[b:b + 1], m, p, k=kl)
            assert torch.equal(got[0][..., :k], want[0]), p
            assert torch.equal(got[1][..., :k], want[1]), p


PT_SHAPES = [(16384, 16384, 8), (16384, 4096, 16), (4096, 4096, 16),
             (1024, 256, 16), (64, 64, 16), (4096, 16384, 3), (64, 256, 3)]


@pytest.mark.parametrize("n,q,k", PT_SHAPES)
def test_exact_plan_per_k(n, q, k):
    """The plan's list length and shared memory per k at
    PointTransformer's shapes (B = 2): lists of 4, 8 or 16 entries; the
    shared memory the larger of the tile and the tree merge's lists plus
    the posted bounds, as ``shared_bytes`` in ``knn_exact.cu`` computes
    it, within what a block may have; the rest of the plan as at k = 16."""
    plan = ck.exact_plan(2, n, q, sms=132, k=k)
    base = ck.exact_plan(2, n, q, sms=132)
    assert {key: plan[key] for key in ("qpt", "warps", "chunk")} == {
        key: base[key] for key in ("qpt", "warps", "chunk")}
    kl, qpt, nw, chunk = plan["list"], plan["qpt"], plan["warps"], \
        plan["chunk"]
    assert kl == ck.list_len(k) and kl >= k and kl & (kl - 1) == 0
    tile = (nw * chunk + 32) * 16
    merge = nw // 2 * qpt * kl * 32 * 8
    assert plan["shared"] == max(tile, merge) + 4 * nw * 32 * qpt * 4
    assert 0 < plan["shared"] <= 232_448
    assert [ck.list_len(k) for k in (3, 4, 5, 8, 9, 16)] == [
        4, 4, 8, 8, 16, 16]
