"""The port's voxel and stencil ops against the JAX package.

Both sides get the same numpy inputs. ``voxelize``, the Morton site ops and
the hash ops are integer work and must agree exactly (the float products of
the hash convolutions to 1e-6). The stencil convolution's plain version is
held against ``stencil_conv_pallas`` as the JAX package's own tests run it
on the CPU: its XLA twin (``interpret=True``), and at tiny shapes the
Pallas kernel itself in Mosaic interpret mode (``_INTERPRET_KERNEL``).
"""

import numpy as np
import pytest
import torch

import importlib

import jax
import jax.numpy as jnp

from open3d_ml_tpu.ops import sparse as jsp
from open3d_ml_tpu.ops import sparse_bucket as jsb
from open3d_ml_tpu.ops.pallas import stencil as ps
from open3d_ml_tpu_torch.models import SparseConvUnet
from open3d_ml_tpu_torch.models import sparseconvunet as tscu
from open3d_ml_tpu_torch.ops import sparse as tsp
from open3d_ml_tpu_torch.ops import sparse_bucket as tsb
from open3d_ml_tpu_torch.ops import voxelize as tvox
from open3d_ml_tpu_torch.ops.cuda import stencil as cs
from torch_threads import one_torch_thread  # noqa: F401

# the JAX package's ops/__init__ rebinds the name ``voxelize`` to the
# function
jvox = importlib.import_module("open3d_ml_tpu.ops.voxelize")
I32MAX = np.iinfo(np.int32).max
OFFS27 = tsp.kernel_offsets(3, centered=True)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def site_scene(b=2, cap=256, box=12, seed=0):
    """[b, cap, 3] int32 distinct sites in a box, uneven valid counts,
    Morton-sorted by the port: (coords, mask, key, inv_perm) tensors."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((b, cap, 3), np.int32)
    mask = np.zeros((b, cap), bool)
    for i in range(b):
        c = np.unique(rng.integers(0, box, (cap * 2, 3)), axis=0)
        rng.shuffle(c)
        n = min(len(c), cap - 7 + i)
        coords[i, :n] = c[:n]
        mask[i, :n] = True
    return tsb.sort_sites(_t(coords), _t(mask))


# ------------------------------------------------------------------ voxelize

@pytest.mark.parametrize("max_voxels, max_points", [(4096, 64), (300, 64),
                                                    (4096, 3), (50, 2)])
def test_voxelize_matches_jax(max_voxels, max_points):
    """Out-of-range points on every side, masked points, and caps that
    saturate (voxels, points per voxel, or both)."""
    rng = np.random.default_rng(max_voxels + max_points)
    pts = rng.uniform(-2, 18, (3000, 3)).astype(np.float32)
    pts[:1500] = np.floor(rng.uniform(0, 8, (1500, 3))) + 0.5  # repeats
    pmask = rng.random(3000) > 0.1
    args = ((1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (16.0, 16.0, 16.0), max_voxels,
            max_points)
    ref = jvox.voxelize(jnp.asarray(pts), *args,
                        points_mask=jnp.asarray(pmask))
    got = tvox.voxelize(_t(pts), *args, points_mask=_t(pmask))
    for name in tvox.VoxelData._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(ref, name)), err_msg=name)


def test_voxelize_scaled_voxel_size():
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 5, (2000, 3)).astype(np.float32)
    args = ((0.25, 0.5, 0.3), (0.0, -0.5, 0.1), (4.0, 4.5, 3.1), 1000, 8)
    ref = jvox.voxelize(jnp.asarray(pts), *args)
    got = tvox.voxelize(_t(pts), *args)
    for name in tvox.VoxelData._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      _np(getattr(ref, name)), err_msg=name)


# ------------------------------------------------------------ Morton sites

@pytest.fixture(scope="module")
def scene():
    coords, mask, key, inv = site_scene()
    return {"coords": coords, "mask": mask, "key": key, "inv": inv}


def test_morton_key_int_matches_jax():
    rng = np.random.default_rng(1)
    c = rng.integers(-3, 1030, (4000, 3)).astype(np.int32)
    m = rng.random(4000) > 0.2
    np.testing.assert_array_equal(
        tsb.morton_key_int(_t(c), _t(m)).numpy(),
        _np(jsb.morton_key_int(jnp.asarray(c), jnp.asarray(m))))


def test_sort_sites_matches_jax():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 40, (2, 600, 3)).astype(np.int32)
    m = rng.random((2, 600)) > 0.3
    got = tsb.sort_sites(_t(c), _t(m))
    ref = jsb.sort_sites(jnp.asarray(c), jnp.asarray(m))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), _np(r))


@pytest.mark.parametrize("seg", [16, 48])
def test_support_points_matches_jax(scene, seg):
    got = tsb.support_points(scene["coords"], scene["mask"], seg)
    ref = jsb.support_points(jnp.asarray(scene["coords"].numpy()),
                             jnp.asarray(scene["mask"].numpy()), seg)
    np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_stencil_query_keys_matches_jax(scene):
    coords = scene["coords"].numpy().copy()
    coords[0, :5] = [1020, 3, 0]  # taps beyond the 1024^3 domain
    for offs in (OFFS27, tsp.kernel_offsets(2, centered=False)):
        got = tsb.stencil_query_keys(_t(coords), scene["mask"], offs)
        ref = jsb.stencil_query_keys(jnp.asarray(coords),
                                     jnp.asarray(scene["mask"].numpy()), offs)
        np.testing.assert_array_equal(got.numpy(), _np(ref))


@pytest.mark.parametrize("cap", [256, 100, 30])
def test_bucket_downsample_matches_jax(scene, cap):
    """Generous and saturated parent caps."""
    args = [scene[k] for k in ("coords", "mask", "key")]
    got = tsb.bucket_downsample(*args, cap)
    ref = jsb.bucket_downsample(*(jnp.asarray(a.numpy()) for a in args), cap)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), _np(r))
    assert (cap < 256) == bool(got[4].sum() > 0)


@pytest.mark.parametrize("qblock, num_segs, reach", [(32, 4, 1.74),
                                                     (16, 16, 1.74),
                                                     (128, 3, 0.1),
                                                     (32, 100, 1.74)])
def test_rank_site_segments_matches_jax(scene, qblock, num_segs, reach):
    """seg_ids equal wherever the scores are finite and distinct (where
    they tie, both keep the lower index; where they are inf, the order of
    the tail is irrelevant); overflow equal."""
    seg = 16
    coords, mask = scene["coords"], scene["mask"]
    nv = mask.sum(1).to(torch.int32)
    sup = tsb.support_points(coords, mask, seg)
    sites = torch.where(mask[..., None], coords.float(), 2e9)
    got = tsb.rank_site_segments(sup, nv, sites, nv, seg=seg, qblock=qblock,
                                 num_segs=num_segs, reach=reach)
    ref = jsb.rank_site_segments(jnp.asarray(sup.numpy()),
                                 jnp.asarray(nv.numpy()),
                                 jnp.asarray(sites.numpy()),
                                 jnp.asarray(nv.numpy()), seg=seg,
                                 qblock=qblock, num_segs=num_segs,
                                 reach=reach)
    np.testing.assert_array_equal(got[1].numpy(), _np(ref[1]))
    sids, rsids = got[0].numpy(), _np(ref[0])
    assert sids.shape == rsids.shape
    # score of each kept segment, recomputed in float64 from the bboxes
    plo, phi = (x.double() for x in tsb._masked_bboxes(sup, nv, seg))
    qlo, qhi = (x.double() for x in tsb._masked_bboxes(sites, nv, qblock))
    gap = torch.clamp(torch.maximum(qlo[:, :, None] - phi[:, None],
                                    plo[:, None] - qhi[:, :, None]), min=0)
    lb = gap.norm(dim=-1)
    cd = ((qlo + qhi)[:, :, None] - (plo + phi)[:, None]).norm(dim=-1) / 2
    srt = np.sort((lb * 1e4 + cd.clamp(max=1e3)).numpy(), -1)
    # rank j is unambiguous where its score is finite and apart from the
    # scores ranked beside it; seg_ids lists the segments by rank
    apart = np.ones_like(srt, bool)
    step = srt[..., 1:] - srt[..., :-1] > 1e-6 * np.abs(srt[..., 1:])
    apart[..., 1:] &= step
    apart[..., :-1] &= step
    s = sids.shape[-1]
    ok = np.isfinite(srt[..., :s]) & apart[..., :s]
    assert ok.mean() > 0.5
    np.testing.assert_array_equal(sids[ok], rsids[ok])


def test_path_keys_ascend(scene):
    """The kernel's precondition: on the path the support keys (and so
    the keys of every segment) ascend, pad keys INT32_MAX at the end, at
    the sorted level and at every downsampled one."""
    coords, mask, key = scene["coords"], scene["mask"], scene["key"]
    for cap in (256, 128, 64, 32):
        padded = cs._pad_keys(key, 16)
        assert (padded[:, 1:] >= padded[:, :-1]).all()
        assert (padded[~torch.nn.functional.pad(mask, (0, padded.shape[1] -
                                                       mask.shape[1]))] ==
                I32MAX).all()
        coords, mask, key, _, _ = tsb.bucket_downsample(coords, mask, key,
                                                        cap)


@pytest.mark.parametrize("levels", [3, 7])
def test_keys_ascend_at_every_level_of_the_net(monkeypatch, levels):
    """What the stencil kernels' sorted tables rely on, at every
    convolution the stencil net runs on synthetic rooms: the keys of each
    batch row ascend (valid keys distinct, pad keys INT32_MAX at the end),
    so the segments' key ranges are disjoint and ascend with the segment
    id."""
    from test_torch_scu import surface_batch
    seen = []
    real = tscu.stencil_conv

    def capture(values, keys, *args, **kwargs):
        seen.append((keys, kwargs["seg"]))
        return real(values, keys, *args, **kwargs)

    monkeypatch.setattr(tscu, "stencil_conv", capture)
    model = SparseConvUnet(multiplier=2, num_levels=levels, max_voxels=4096,
                           num_points=800, compute_dtype="float32")
    net = model.get_net().eval()
    batch = surface_batch(np.random.default_rng(levels), b=2, n=800)
    with torch.no_grad():
        net({k: torch.from_numpy(v) for k, v in batch.items()})
    assert len({keys.shape[1] for keys, _ in seen}) == levels
    for keys, seg in seen:
        padded = cs._pad_keys(keys, seg).long()
        valid = padded < I32MAX
        assert (padded[:, 1:] >= padded[:, :-1]).all()
        assert (padded[:, 1:][valid[:, 1:]] >
                padded[:, :-1][valid[:, 1:]]).all()  # distinct
        assert (valid[:, 1:] <= valid[:, :-1]).all()  # pads at the end
        segs = padded.reshape(padded.shape[0], -1, seg)
        lo, hi = segs.min(-1).values, segs.max(-1).values
        assert (hi[:, :-1] <= lo[:, 1:]).all()
        assert (hi[:, :-1] < lo[:, 1:])[lo[:, 1:] < I32MAX].all()


# ----------------------------------------------------------------- hash ops

def test_linearize_and_kernel_offsets_match_jax():
    rng = np.random.default_rng(3)
    c = rng.integers(-2, 1030, (3000, 3)).astype(np.int32)
    m = rng.random(3000) > 0.2
    np.testing.assert_array_equal(
        tsp.linearize(_t(c), _t(m)).numpy(),
        _np(jsp.linearize(jnp.asarray(c), jnp.asarray(m))))
    for size, centered in ((3, True), (2, False), (5, True)):
        np.testing.assert_array_equal(tsp.kernel_offsets(size, centered),
                                      jsp.kernel_offsets(size, centered))


@pytest.fixture(scope="module")
def hash_scene():
    rng = np.random.default_rng(4)
    c = np.unique(rng.integers(0, 14, (900, 3)), axis=0).astype(np.int32)
    rng.shuffle(c)
    cap = 700
    coords = np.zeros((cap, 3), np.int32)
    coords[:min(len(c), 650)] = c[:650]
    mask = np.arange(cap) < min(len(c), 650)
    return coords, mask, rng


def test_rulebook_and_lookup_match_jax(hash_scene):
    coords, mask, _ = hash_scene
    got = tsp.build_rulebook(_t(coords), _t(mask), OFFS27)
    ref = jsp.build_rulebook(jnp.asarray(coords), jnp.asarray(mask), OFFS27)
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    q = coords + 1
    idx, found = tsp.SiteHash(_t(coords), _t(mask)).lookup(_t(q), _t(mask))
    ridx, rfound = jsp.SiteHash(jnp.asarray(coords),
                                jnp.asarray(mask)).lookup(jnp.asarray(q),
                                                          jnp.asarray(mask))
    np.testing.assert_array_equal(idx.numpy(), _np(ridx))
    np.testing.assert_array_equal(found.numpy(), _np(rfound))


@pytest.mark.parametrize("cap", [700, 120])
def test_unique_and_downsample_sites_match_jax(hash_scene, cap):
    coords, mask, _ = hash_scene
    for fn in ("unique_sites", "downsample_sites"):
        got = getattr(tsp, fn)(_t(coords), _t(mask), cap)
        ref = getattr(jsp, fn)(jnp.asarray(coords), jnp.asarray(mask), cap)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), _np(r), err_msg=fn)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_hash_convs_match_jax(hash_scene, compute_dtype):
    """Gather-GEMM and transpose convolutions: float32 products in another
    summation order, within 1e-6 of the largest output (bf16 rounds the
    same inputs on both sides, and its products are exact in float32)."""
    coords, mask, rng = hash_scene
    v = coords.shape[0]
    feats = rng.standard_normal((v, 6)).astype(np.float32)
    w = (rng.standard_normal((27, 6, 5)) * 0.3).astype(np.float32)
    rb = tsp.build_rulebook(_t(coords), _t(mask), OFFS27)
    tdt = None if compute_dtype is None else torch.bfloat16
    jdt = None if compute_dtype is None else jnp.bfloat16
    for normalize in (False, True):
        got = tsp.apply_sparse_conv(_t(feats), rb, _t(w), out_mask=_t(mask),
                                    normalize=normalize, compute_dtype=tdt)
        ref = _np(jsp.apply_sparse_conv(
            jnp.asarray(feats), jnp.asarray(rb.numpy()), jnp.asarray(w),
            out_mask=jnp.asarray(mask), normalize=normalize,
            compute_dtype=jdt))
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    pc, pm, parent, off = tsp.downsample_sites(_t(coords), _t(mask), 300)
    coarse = rng.standard_normal((300, 7)).astype(np.float32)
    wu = (rng.standard_normal((8, 7, 4)) * 0.3).astype(np.float32)
    got = tsp.apply_sparse_conv_transpose(_t(coarse), parent, off, _t(wu),
                                          out_mask=_t(mask),
                                          compute_dtype=tdt)
    ref = _np(jsp.apply_sparse_conv_transpose(
        jnp.asarray(coarse), jnp.asarray(parent.numpy()),
        jnp.asarray(off.numpy()), jnp.asarray(wu), out_mask=jnp.asarray(mask),
        compute_dtype=jdt))
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


# -------------------------------------------------------------- stencil conv

def stencil_case(form, seg, qblock, num_segs, cin, cout, rng, b=2, cap=256,
                 box=12, seed=0):
    """The inputs of one stencil convolution of the path at a small size:
    ``form`` is "sub" (27 taps), "down" (8 child-code taps of the parents)
    or "up" (8 taps, one live: the fine sites' parent)."""
    coords, mask, mkey, _ = site_scene(b, cap, box, seed)
    nv = mask.sum(1).to(torch.int32)
    sup = tsb.support_points(coords, mask, seg)
    child = torch.arange(8, dtype=torch.int32)
    dcap = cap // 2
    pcoords, pmask, pkey, off_idx, _ = tsb.bucket_downsample(coords, mask,
                                                             mkey, dcap)
    npar = pmask.sum(1).to(torch.int32)
    if form == "sub":
        keys, v = mkey, cap
        qkeys = tsb.stencil_query_keys(coords, mask, OFFS27)
        seg_ids, ovf = tsb.rank_site_segments(
            sup, nv, coords.float(), nv, seg=seg, qblock=qblock,
            num_segs=num_segs, reach=1.74)
    elif form == "down":
        keys, v = mkey, cap
        qkeys = torch.where(pmask[..., None], (pkey[..., None] << 3) | child,
                            -1)
        pq = torch.where(pmask[..., None], (pcoords * 2).float(), 2e9)
        seg_ids, ovf = tsb.rank_site_segments(
            sup, nv, pq, npar, seg=seg, qblock=qblock, num_segs=num_segs,
            reach=1.74)
    else:
        keys, v = pkey, dcap
        qkeys = torch.where(mask[..., None] & (off_idx[..., None] == child),
                            (mkey >> 3)[..., None], -1)
        supp = tsb.support_points(pcoords, pmask, seg)
        fq = torch.where(mask[..., None], (coords >> 1).float(), 2e9)
        seg_ids, ovf = tsb.rank_site_segments(
            supp, npar, fq, nv, seg=seg, qblock=qblock, num_segs=num_segs,
            reach=0.1)
    k = qkeys.shape[-1]
    values = rng.standard_normal((b, v, cin)).astype(np.float32)
    w = (rng.standard_normal((k, cin, cout)) * 0.3).astype(np.float32)
    return {"values": values, "keys": keys.numpy(), "qkeys": qkeys.numpy(),
            "seg_ids": seg_ids.numpy(), "w": w, "seg": seg, "qblock": qblock,
            "overflow": int(ovf.sum())}


def _plain(case, dtype):
    return cs.stencil_conv_plain(
        _t(case["values"]), _t(case["keys"]), _t(case["qkeys"]),
        _t(case["seg_ids"]), _t(case["w"]), seg=case["seg"],
        qblock=case["qblock"], compute_dtype=dtype).numpy()


def _pallas(case, dtype):
    return _np(ps.stencil_conv_pallas(
        jnp.asarray(case["values"]), jnp.asarray(case["keys"]),
        jnp.asarray(case["qkeys"]), jnp.asarray(case["seg_ids"]),
        jnp.asarray(case["w"]), case["seg"], case["qblock"], dtype, True))


DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("form, qblock, num_segs", [
    ("sub", 32, 16), ("sub", 32, 2), ("down", 32, 16), ("down", 32, 1),
    ("up", 128, 16), ("up", 128, 1), ("sub", 32, 72)])
def test_stencil_conv_plain_matches_xla_twin(form, qblock, num_segs, dtype):
    """The XLA twin of ``stencil_conv_pallas`` and the plain version round
    the same inputs (at bf16) and sum float32 products in other orders:
    1e-5 of the largest output. The S = 1 or 2 cases overflow, so taps
    whose site lies outside the block's table miss on both sides; S = 72
    makes a table of 1,152 rows, past the kernels' former limit of
    1,024."""
    rng = np.random.default_rng(len(form) + qblock + num_segs)
    big = num_segs > 16  # 1,400 sites: enough segments for S = 72
    case = stencil_case(form, 16, qblock, num_segs, 12, 10, rng,
                        cap=1400 if big else 256, box=14 if big else 12)
    assert not big or case["seg_ids"].shape[-1] == num_segs
    if num_segs <= 2:
        assert case["overflow"] > 0
    tdt, jdt = DTYPES[dtype]
    got = _plain(case, tdt)
    ref = _pallas(case, jdt)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    if num_segs <= 2:
        full = dict(case, seg_ids=np.broadcast_to(
            np.arange(-(-case["values"].shape[1] // 16), dtype=np.int32),
            case["seg_ids"].shape[:2] + (-(-case["values"].shape[1] // 16),)
        ).copy())
        # with every segment in the table more taps hit
        assert np.abs(_plain(full, tdt) - got).max() > 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stencil_conv_plain_matches_mosaic_kernel(monkeypatch, dtype):
    """The Pallas TPU kernel itself, run by the Mosaic interpreter on a
    tiny scene, against the plain version."""
    monkeypatch.setattr(ps, "_INTERPRET_KERNEL", True)
    jax.clear_caches()
    rng = np.random.default_rng(7)
    case = stencil_case("sub", 16, 8, 2, 4, 8, rng, b=1, cap=64, box=8,
                        seed=7)
    tdt, jdt = DTYPES[dtype]
    got = _plain(case, tdt)
    ref = _pallas(case, jdt)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_stencil_conv_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(8)
    case = stencil_case("sub", 16, 32, 4, 5, 6, rng)
    before = dict(cs.LAUNCHES)
    args = [_t(case[k]) for k in ("values", "keys", "qkeys", "seg_ids", "w")]
    got = cs.stencil_conv(*args, seg=16, qblock=32,
                          compute_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), _plain(case, torch.float32))
    assert cs.LAUNCHES == before


def _kernel_route(monkeypatch):
    """Send the wrappers of ``ops/cuda/stencil.py`` down the kernel route on
    CPU tensors, into a fake library that records each launch's arguments
    and gives stand-in shared-memory sizes (4 bytes per table key, and 8 KB
    per row tile and ring stage at bf16 or 256 bytes per query at
    float32)."""
    from open3d_ml_tpu_torch.ops.cuda import _build
    calls = []

    class Library:
        def stencil_conv_launch(self, *args):
            calls.append(("conv", args))
            return 0

        def stencil_match_launch(self, *args):
            calls.append(("match", args))
            return 0

        def stencil_conv_shared(self, route, ct, mw, stages, qblock, k, s,
                                seg):
            return 4 * s * seg + (8192 * mw * stages if route else
                                  256 * qblock)

        def stencil_match_shared(self, s, seg):
            return 4 * s * seg

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(cs, "route", lambda t, family: "kernel")
    monkeypatch.setattr(cs, "stream", lambda: 0)
    monkeypatch.setattr(cs, "_sm_count", lambda index: 132)
    monkeypatch.setattr(cs, "LAUNCHES", dict.fromkeys(cs.LAUNCHES, 0))
    return calls


@pytest.mark.parametrize("form, qblock, cin, cout", [
    ("sub", 32, 32, 32), ("sub", 32, 224, 224), ("up", 128, 64, 32),
    ("down", 32, 3, 40)])
def test_stencil_conv_wrapper_passes_the_plan(monkeypatch, form, qblock, cin,
                                              cout):
    """On the kernel route ``stencil_conv`` hands its entry point the route
    (1: the bf16 tensor-core kernel at compute_dtype bfloat16, 0: the
    float32 FMA kernel), the block's output channels, row tiles and ring
    depth, and the shared memory that ``conv_plan`` sizes for them; one
    launch per call."""
    calls = _kernel_route(monkeypatch)
    rng = np.random.default_rng(11)
    case = stencil_case(form, 16, qblock, 16, cin, cout, rng)
    args = [_t(case[k]) for k in ("values", "keys", "qkeys", "seg_ids", "w")]
    b, q, k = case["qkeys"].shape
    s = case["seg_ids"].shape[-1]
    for dtype, route in ((torch.float32, 0), (torch.bfloat16, 1)):
        cs.stencil_conv(*args, seg=16, qblock=qblock, compute_dtype=dtype)
        plan = cs.conv_plan(b, q, k, cin, cout, s, 16, qblock,
                            bf16=route == 1, sms=132)
        assert plan["route"] == route
        kind, got = calls[-1]
        # ..., B at 6, ..., route, ct, mw, stages, shared, stream
        assert kind == "conv" and got[6] == b
        assert got[-6:-1] == (route, plan["ct"], plan["mw"], plan["stages"],
                              plan["shared"])
        assert 0 < plan["shared"] <= cs.SMEM_LIMIT
    assert cs.LAUNCHES == {"stencil_conv": 2, "stencil_match": 0}


def test_conv_plan_fills_the_card_and_sizes_its_shared_memory(monkeypatch):
    """bf16 plans at the room request's shapes: the wide levels share a
    block's weight tiles among 4 row tiles; the deepest level splits the
    taps among the warps and narrows the output tile so that every SM gets
    a block. The shared memory is the kernel library's size of the plan
    (stand-in sizes here), with a ring of 3 stages where two blocks fit on
    an SM, else 2; a plan or a rulebook table past the shared memory is
    refused, naming its size."""
    from open3d_ml_tpu_torch.ops.cuda import _build
    _kernel_route(monkeypatch)
    size = _build.library().stencil_conv_shared
    level0 = cs.conv_plan(1, 40000, 27, 32, 32, 16, 64, 32, bf16=True,
                          sms=132)
    assert level0 == {"route": 1, "ct": 32, "mw": 4, "stages": 3,
                      "shared": size(1, 32, 4, 3, 32, 27, 16, 64)}
    deepest = cs.conv_plan(1, 632, 27, 224, 224, 16, 64, 32, bf16=True,
                           sms=132)
    assert (deepest["mw"], deepest["ct"]) == (1, 32)  # 20 x 7 blocks
    # three stages would leave room for one block per SM only
    wide = cs.conv_plan(1, 40000, 27, 32, 32, 256, 64, 32, bf16=True,
                        sms=132)
    assert size(1, 32, 4, 3, 32, 27, 256, 64) > cs._SMEM_HALF_SM
    assert (wide["stages"], wide["shared"]) == (
        2, size(1, 32, 4, 2, 32, 27, 256, 64))
    assert cs.conv_plan(1, 40000, 27, 32, 32, 32, 64, 32, bf16=False,
                        sms=132) == {"route": 0, "ct": 32, "mw": 1,
                                     "stages": 0,
                                     "shared": size(0, 32, 1, 0, 32, 27, 32,
                                                    64)}
    for bf16 in (False, True):
        with pytest.raises(ValueError, match="bytes of shared memory"):
            cs.conv_plan(1, 40000, 27, 32, 32, 1024, 64, 32, bf16=bf16,
                         sms=132)
    assert cs.match_shared(32, 64) == 4 * 32 * 64
    with pytest.raises(ValueError, match="262144 bytes of shared memory"):
        cs.match_shared(1024, 64)


@pytest.mark.parametrize("bad", ["dtype", "shape", "qblock", "compute"])
def test_stencil_conv_wrapper_rejects(bad):
    rng = np.random.default_rng(9)
    case = stencil_case("sub", 16, 32, 4, 5, 6, rng)
    args = [_t(case[k]) for k in ("values", "keys", "qkeys", "seg_ids", "w")]
    kw = dict(seg=16, qblock=32, compute_dtype=torch.float32)
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[4] = args[4][:, :4]
    elif bad == "qblock":
        kw["qblock"] = 16
    else:
        kw["compute_dtype"] = torch.float16
    with pytest.raises(ValueError):
        cs.stencil_conv(*args, **kw)


def test_stencil_conv_plain_float64_reference():
    """Float64 inputs give a float64 result (the card's error bound is
    taken against it), equal to the float32 one to float32 rounding."""
    rng = np.random.default_rng(10)
    case = stencil_case("down", 16, 32, 16, 6, 7, rng)
    got32 = _plain(case, torch.float32)
    ref = cs.stencil_conv_plain(
        _t(case["values"]).double(), _t(case["keys"]), _t(case["qkeys"]),
        _t(case["seg_ids"]), _t(case["w"]).double(), seg=16, qblock=32,
        compute_dtype=torch.float32)
    assert ref.dtype == torch.float64
    assert np.abs(got32 - ref.numpy()).max() <= 1e-5 * np.abs(got32).max()
