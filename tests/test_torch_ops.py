"""The port's point ops (``open3d_ml_tpu_torch/ops``) against the JAX package.

Both sides get the same numpy inputs. The JAX bucket kernels run as the JAX
package's own tests run them on the CPU (``interpret=True``: their XLA
twins, or the Pallas kernels themselves in Mosaic interpret mode where a
test sets ``_INTERPRET_KERNEL``, as ``tests/test_bucket.py`` does); the
port's kernel wrappers take their plain versions for CPU tensors.

Where indices are compared, the points lie on a 1/32 lattice in [-4, 4)^3:
every squared distance is then exact in float32 under both the twin's
cross-term formula and the port's direct one, so ties break by table
position on both sides and the pyramids agree index for index.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open3d_ml_tpu.ops import bucket as jb
from open3d_ml_tpu.ops.morton import hilbert_codes as jax_hilbert_codes
from open3d_ml_tpu.ops.pallas import bucket as pb
from open3d_ml_tpu_torch.ops import bucket as tb
from open3d_ml_tpu_torch.ops.cuda import bucket as cb
from open3d_ml_tpu_torch.ops.morton import hilbert_codes, hilbert_sort
from torch_threads import one_torch_thread  # noqa: F401

B, N, SEG, QBLOCK, S, K = 2, 2560, 32, 64, 6, 16


def lattice_cloud(rng, b, n):
    """[b, n, 3] distinct points of the 1/32 grid in [-4, 4)^3."""
    clouds = []
    for _ in range(b):
        v = rng.choice(256 ** 3, n, replace=False)
        clouds.append(np.stack([v % 256, (v // 256) % 256, v // 65536], -1))
    return (np.stack(clouds) / 32.0 - 4.0).astype(np.float32)


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def search():
    """A sorted lattice batch, its segment tables and the JAX twin's KNN."""
    rng = np.random.default_rng(0)
    _, sp = hilbert_sort(torch.from_numpy(lattice_cloud(rng, B, N)))
    seg_ids = tb.select_segments(sp, sp, seg=SEG, qblock=QBLOCK, num_segs=S)
    pcp = tb.pad_seg(sp, SEG, fill=1e9)
    rel, d2 = pb.knn_pallas(jnp.asarray(pcp.numpy()), jnp.asarray(sp.numpy()),
                            jnp.asarray(seg_ids.numpy()), K, seg=SEG,
                            qblock=QBLOCK, interpret=True)
    return {"sp": sp, "pcp": pcp, "seg_ids": seg_ids, "rel": _np(rel),
            "d2": _np(d2), "rng": rng}


@pytest.mark.parametrize("scale", [0.25, 2.5, 25.0, 250.0])
def test_hilbert_codes_bitwise(scale):
    rng = np.random.default_rng(1)
    pts = (rng.uniform(-1, 1, (3, 45056, 3)) * scale +
           rng.uniform(-5, 5, (3, 1, 3))).astype(np.float32)
    ref = _np(jax.jit(jax.vmap(jax_hilbert_codes))(jnp.asarray(pts)))
    np.testing.assert_array_equal(hilbert_codes(torch.from_numpy(pts)).numpy(),
                                  ref)


def test_hilbert_sort_is_stable_argsort():
    rng = np.random.default_rng(2)
    # a coarse grid repeats codes, so the tie order is exercised
    pts = rng.integers(0, 4, (2, 512, 3)).astype(np.float32)
    perm, sp = hilbert_sort(torch.from_numpy(pts))
    codes = _np(jax.vmap(jax_hilbert_codes)(jnp.asarray(pts)))
    ref = np.argsort(codes, axis=1, kind="stable")
    np.testing.assert_array_equal(perm.numpy(), ref)
    np.testing.assert_array_equal(sp.numpy(),
                                  np.take_along_axis(pts, ref[..., None], 1))


@pytest.mark.parametrize("kind", ["lattice", "uniform"])
def test_select_segments_matches_jax(kind):
    rng = np.random.default_rng(3)
    pts = (lattice_cloud(rng, B, N) if kind == "lattice" else
           rng.uniform(-10, 10, (B, N, 3)).astype(np.float32))
    _, sp = hilbert_sort(torch.from_numpy(pts))
    sub = sp[:, ::4]
    for queries, num_segs in ((sp, S), (sub, S), (sp, 200)):
        ref = jb.select_segments(jnp.asarray(sp.numpy()),
                                 jnp.asarray(queries.numpy()), seg=SEG,
                                 qblock=QBLOCK, num_segs=num_segs)
        got = tb.select_segments(sp, queries, seg=SEG, qblock=QBLOCK,
                                 num_segs=num_segs)
        np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_knn_plain_lattice_exact(search):
    rel, d2 = cb.knn_bucket_plain(search["pcp"], search["sp"],
                                  search["seg_ids"], K, seg=SEG,
                                  qblock=QBLOCK)
    assert rel.dtype == torch.int32 and d2.dtype == torch.float32
    np.testing.assert_array_equal(rel.numpy(), search["rel"])
    np.testing.assert_array_equal(d2.numpy(), search["d2"])


@pytest.mark.parametrize("k", [1, 16])
def test_knn_plain_uniform_close(k):
    """Float coordinates: the twin's cross-term formula leaves ~1e-4 of
    residue in d2, so nearly tied neighbours may swap; the sorted
    distances and the neighbour sets must still agree."""
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.uniform(-10, 10, (B, N, 3)).astype(np.float32))
    _, sp = hilbert_sort(pts)
    queries = sp[:, ::4][:, :N // 4 - 3].contiguous()  # ragged last block
    seg_ids = tb.select_segments(sp, queries, seg=SEG, qblock=QBLOCK,
                                 num_segs=S)
    pcp = tb.pad_seg(sp, SEG, fill=1e9)
    rel_j, d2_j = pb.knn_pallas(jnp.asarray(pcp.numpy()),
                                jnp.asarray(queries.numpy()),
                                jnp.asarray(seg_ids.numpy()), k, seg=SEG,
                                qblock=QBLOCK, interpret=True)
    rel, d2 = cb.knn_bucket(pcp, queries, seg_ids, k, seg=SEG, qblock=QBLOCK)
    assert rel.shape == (B, queries.shape[1], k)
    np.testing.assert_allclose(d2.numpy(), _np(d2_j), rtol=1e-5, atol=1e-3)
    same = (np.sort(rel.numpy(), -1) == np.sort(_np(rel_j), -1)).all(-1)
    assert same.mean() >= 0.995, same.mean()


@pytest.mark.parametrize("round_bf16", [False, True])
def test_gather_plain_matches_jax(search, round_bf16):
    rng = np.random.default_rng(5)
    values = rng.standard_normal((B, N, 35)).astype(np.float32)
    seg_ids, rel = search["seg_ids"], torch.from_numpy(search["rel"])
    jax_values = (torch.from_numpy(values).bfloat16().float().numpy()
                  if round_bf16 else values)
    for qblock, rows in ((QBLOCK, rel), (QBLOCK // 4, rel[:, ::4])):
        # the reuse layout of the pool gather: rows ::4 of the same tables,
        # qblock / 4 queries per table
        ref = pb.gather_pallas(jnp.asarray(jax_values),
                               jnp.asarray(seg_ids.numpy()),
                               jnp.asarray(rows.numpy()), SEG, qblock,
                               jnp.float32, True)
        got = cb.gather_bucket(torch.from_numpy(values), seg_ids,
                               rows.contiguous(), seg=SEG, qblock=qblock,
                               round_bf16=round_bf16)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), _np(ref))


def test_compact_tables_matches_jax(search):
    seg_ids = search["seg_ids"]
    for g in (4, 2):
        ref = jb.compact_tables(jnp.asarray(seg_ids.numpy()),
                                jnp.asarray(search["rel"]), g, seg=SEG,
                                qblock=QBLOCK)
        got = tb.compact_tables(seg_ids, torch.from_numpy(search["rel"]), g,
                                seg=SEG, qblock=QBLOCK)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), _np(b))


def test_compact_tables_ragged_queries():
    """Q not a multiple of qblock: the pad rows must not count as hits."""
    rng = np.random.default_rng(6)
    nqb, s, q, k = 3, 8, 150, 4
    seg_ids = np.stack([rng.choice(40, (nqb, s), replace=False)
                        for _ in range(B)]).astype(np.int32)
    rel = rng.integers(0, s * SEG, (B, q, k)).astype(np.int32)
    ref = jb.compact_tables(jnp.asarray(seg_ids), jnp.asarray(rel), 3,
                            seg=SEG, qblock=QBLOCK)
    got = tb.compact_tables(torch.from_numpy(seg_ids), torch.from_numpy(rel),
                            3, seg=SEG, qblock=QBLOCK)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), _np(b))


@pytest.mark.parametrize("q", [N, 150])
def test_derive_up_tables_matches_jax(search, q):
    seg_ids, rel = search["seg_ids"], search["rel"]
    if q != N:  # fewer queries than the tables' blocks hold
        seg_ids, rel = seg_ids[:, :-(-q // QBLOCK)], rel[:, :q]
    ref = jb.derive_up_tables(jnp.asarray(seg_ids.numpy()), jnp.asarray(rel),
                              4, seg=SEG)
    got = tb.derive_up_tables(seg_ids.contiguous(),
                              torch.from_numpy(np.ascontiguousarray(rel)), 4,
                              seg=SEG)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_build_bucket_pyramid_matches_jax():
    """N = 2560 at seg 32, qblock 64 reaches every branch of the shipped
    path: compaction, the pool reuse (levels 0-1), the pool search (levels
    2-3, where N % qblock != 0), derived upsample tables and S clamped by
    the level size."""
    rng = np.random.default_rng(7)
    pts = lattice_cloud(rng, B, N)
    kw = dict(seg=SEG, qblock=QBLOCK, num_segs=S, gather_segs=4)
    ref = jax.jit(lambda p: jb.build_bucket_pyramid_tpu(
        p, K, [4, 4, 4, 4], up_mode="derive", interpret=True, **kw))(
            jnp.asarray(pts))
    got = tb.build_bucket_pyramid(torch.from_numpy(pts), K, [4, 4, 4, 4],
                                  **kw)
    assert set(got) == set(ref)
    np.testing.assert_array_equal(got["perm"].numpy(), _np(ref["perm"]))
    for key in sorted(set(ref) - {"perm"}):
        assert len(got[key]) == len(ref[key]) == 4, key
        for level, (a, b) in enumerate(zip(got[key], ref[key])):
            a = a.numpy() if torch.is_tensor(a) else a
            np.testing.assert_array_equal(a, _np(b), err_msg=f"{key}[{level}]")
    assert got["pool_qblock"] == [QBLOCK // 4, QBLOCK // 4, QBLOCK, QBLOCK]


def test_pyramid_rejects_searched_upsample():
    pts = torch.zeros((1, 256, 3))
    with pytest.raises(NotImplementedError):
        tb.build_bucket_pyramid(pts, K, [3], seg=SEG, qblock=QBLOCK,
                                num_segs=S)


def test_wrappers_have_no_route_off_cpu_or_cuda(search):
    """A wrapper takes its plain version only for CPU tensors: a tensor on
    any other device is refused, not computed some other way."""
    meta = torch.empty((B, N, 3), device="meta")
    with pytest.raises(ValueError, match="no bucket kernel"):
        cb.knn_bucket(meta, meta, search["seg_ids"].to("meta"), K, seg=SEG,
                      qblock=QBLOCK)
    with pytest.raises(ValueError, match="no bucket kernel"):
        cb.gather_bucket(meta, search["seg_ids"].to("meta"),
                         torch.from_numpy(search["rel"]).to("meta"), seg=SEG,
                         qblock=QBLOCK, round_bf16=False)
    with pytest.raises(ValueError, match="no bucket kernel"):
        cb.gather_bucket_bwd(torch.empty((B, N, K, 3), device="meta"),
                             search["seg_ids"].to("meta"),
                             torch.from_numpy(search["rel"]).to("meta"), N,
                             seg=SEG, qblock=QBLOCK, round_bf16=False)
    assert cb.LAUNCHES == {"bucket_knn": 0, "bucket_gather": 0,
                           "bucket_gather_bwd": 0}


def test_entry_points_match_the_sources():
    """The ctypes argument lists agree with the C entry points of the
    CUDA sources (a mismatch would pass garbage, and nothing here compiles
    them)."""
    import re
    from open3d_ml_tpu_torch.ops.cuda import _build
    import ctypes
    kinds = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds[fn] = ["p" if "*" in a else
                         "f" if a.split()[0] == "float" else "i"
                         for a in args.split(",")]
    assert set(kinds) == set(_build.ENTRY_POINTS)
    for fn, argtypes in _build.ENTRY_POINTS.items():
        assert kinds[fn] == ["p" if t is _build._P else
                             "f" if t is ctypes.c_float else "i"
                             for t in argtypes], fn


def test_build_without_a_toolkit_raises(monkeypatch, tmp_path):
    """Without nvcc the build fails loudly; nothing falls back."""
    import torch.utils.cpp_extension as cpp
    from open3d_ml_tpu_torch.ops.cuda import _build
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    for name in _build.SOURCES:
        (tmp_path / name).write_text("// empty\n")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build()


# ------------------------------------------------------ gather backward

def _bwd_case(qblock, q, s=2, seg=32, k=4, c=8, npad=256, seed=20):
    """Tables, rel and two kinds of cotangents for one gather backward:
    dyadic ones (integers in [-4096, 4096] over 64: exact in float32, and
    their bf16 roundings still multiples of 1/64, so every sum is exact in
    any order) and standard normal ones."""
    rng = np.random.default_rng(seed)
    nqb = -(-q // qblock)
    seg_ids = np.stack([np.stack([rng.choice(npad // seg, s, replace=False)
                                  for _ in range(nqb)])
                        for _ in range(B)]).astype(np.int32)
    rel = rng.integers(0, s * seg, (B, q, k)).astype(np.int32)
    dyadic = (rng.integers(-4096, 4097, (B, q, k, c)) / 64).astype(np.float32)
    normal = rng.standard_normal((B, q, k, c)).astype(np.float32)
    return seg_ids, rel, {"dyadic": dyadic, "normal": normal}, npad, seg


def _jax_gather_bwd(monkeypatch, g, seg_ids, rel, npad, seg, qblock, dtype,
                    kernel):
    """The JAX package's gradient of ``gather_pallas`` for cotangent g,
    through its TPU kernels in Mosaic interpret mode (``kernel``) or its
    XLA twin."""
    # the flag is read while tracing and is not part of JAX's trace cache
    # key, so drop the caches for each setting
    monkeypatch.setattr(pb, "_INTERPRET_KERNEL", kernel)
    jax.clear_caches()
    values = jnp.zeros((B, npad, g.shape[-1]), jnp.float32)
    _, vjp = jax.vjp(lambda v: pb.gather_pallas(
        v, jnp.asarray(seg_ids), jnp.asarray(rel), seg, qblock,
        getattr(jnp, dtype), True), values)
    return np.asarray(vjp(jnp.asarray(g))[0])


def _kernel_cases(kernels):
    """Cases (kernel, qblock, Q, K, C) of a gather kernel test: the two
    TPU kernels at K 4 and C 8, then the channel counts where the CUDA
    kernels change variant (11 and 35: float units; 64 and 128: float4
    units) at both table layouts, with Q not a multiple of qblock. The
    first two cases' ids name only the kernel, qblock and Q."""
    wide, flat = kernels
    cases = [pytest.param(wide, 128, 256, 4, 8, id=f"{wide}-128-256"),
             pytest.param(flat, 32, 128, 4, 8, id=f"{flat}-32-128")]
    for c in (11, 35, 64, 128):
        for path, qblock, q, k in ((wide, 128, 200, 16), (flat, 32, 100, 27)):
            cases.append(pytest.param(path, qblock, q, k, c,
                                      id=f"{path}-{qblock}-{q}-K{k}-C{c}"))
    return cases


@pytest.mark.parametrize("round_bf16", [False, True])
@pytest.mark.parametrize("path, qblock, q, k, c", _kernel_cases(
    ("_gather_kernel", "_gather_flat_kernel")))
def test_gather_plain_matches_tpu_kernels(monkeypatch, path, qblock, q, k,
                                          c, round_bf16):
    """TPU kernel 2 (qblock 128: K one-hot products per block) and kernel
    3 (qblock 32: one flat product over grouped blocks) in Mosaic
    interpret mode against the plain gather: equal bits, the values
    rounded to bf16 exactly where the kernel's bf16 product rounds them
    (``round_bf16``), exact at float32."""
    seg_ids, rel, _, npad, seg = _bwd_case(qblock, q, s=4, k=k, c=c, seed=23)
    values = np.random.default_rng(24).standard_normal(
        (B, npad, c)).astype(np.float32)
    called = []
    kern = getattr(pb, path)
    monkeypatch.setattr(pb, path, lambda *a, **kw: called.append(1) or
                        kern(*a, **kw))
    monkeypatch.setattr(pb, "_INTERPRET_KERNEL", True)
    jax.clear_caches()
    want = pb.gather_pallas(jnp.asarray(values), jnp.asarray(seg_ids),
                            jnp.asarray(rel), seg, qblock,
                            jnp.bfloat16 if round_bf16 else jnp.float32, True)
    assert called, f"{path} did not run"
    got = cb.gather_bucket(torch.from_numpy(values),
                           torch.from_numpy(seg_ids), torch.from_numpy(rel),
                           seg=seg, qblock=qblock, round_bf16=round_bf16)
    assert got.shape == (B, q, k, c)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("cotangent", ["dyadic", "normal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("path, qblock, q, k, c", _kernel_cases(
    ("_gather_bwd_kernel", "_gather_bwd_flat_kernel")))
def test_gather_bwd_plain_matches_tpu_kernels(monkeypatch, path, qblock, q,
                                              k, c, dtype, cotangent):
    """TPU kernel 4 (qblock >= 128: K one-hot products per block) and
    kernel 5 (qblock 32 < 128: one flat product over grouped blocks)
    in Mosaic interpret mode against the plain backward, rounding the
    cotangents to bf16 exactly where the kernel's bf16 product does.
    Dyadic cotangents: equal bits. Normal ones: the sums run in other
    orders, each within the float32 summation bound n * 2^-24 * sum |g|
    of the exact sum over a value row's n readers, so the two are within
    twice that of each other."""
    seg_ids, rel, gs, npad, seg = _bwd_case(qblock, q, k=k, c=c)
    g = gs[cotangent]
    round_bf16 = dtype == "bfloat16"
    called = []
    kern = getattr(pb, path)
    monkeypatch.setattr(pb, path, lambda *a, **kw: called.append(1) or
                        kern(*a, **kw))
    want = _jax_gather_bwd(monkeypatch, g, seg_ids, rel, npad, seg, qblock,
                           dtype, True)
    assert called, f"{path} did not run"
    got = cb.gather_bucket_bwd(torch.from_numpy(g),
                               torch.from_numpy(seg_ids),
                               torch.from_numpy(rel), npad, seg=seg,
                               qblock=qblock, round_bf16=round_bf16).numpy()
    if cotangent == "dyadic":
        np.testing.assert_array_equal(got, want)
        return
    gr = torch.from_numpy(g)
    if round_bf16:
        gr = gr.bfloat16().float()
    kw = dict(seg=seg, qblock=qblock, round_bf16=False)
    ids, rels = torch.from_numpy(seg_ids), torch.from_numpy(rel)
    readers = cb.gather_bucket_bwd_plain(torch.ones_like(gr).double(), ids,
                                         rels, npad, **kw).numpy()
    abs_sum = cb.gather_bucket_bwd_plain(gr.double().abs(), ids, rels, npad,
                                         **kw).numpy()
    bound = readers * 2.0 ** -24 * abs_sum
    assert (np.abs(got - want) <= 2 * bound).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_bwd_plain_matches_xla_twin(monkeypatch, dtype):
    """The JAX CPU twin is an exact float32 scatter-add whatever the
    compute dtype: the plain backward without rounding gives its bits on
    dyadic cotangents."""
    seg_ids, rel, gs, npad, seg = _bwd_case(64, 200, seed=21)
    want = _jax_gather_bwd(monkeypatch, gs["dyadic"], seg_ids, rel, npad,
                           seg, 64, dtype, False)
    got = cb.gather_bucket_bwd_plain(
        torch.from_numpy(gs["dyadic"]), torch.from_numpy(seg_ids),
        torch.from_numpy(rel), npad, seg=seg, qblock=64, round_bf16=False)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("round_bf16", [False, True])
def test_bucket_gather_grad_matches_torch_gather(search, round_bf16):
    """``BucketGather``'s gradient is torch.gather's autograd gradient of
    the same reads, with the cotangents rounded to bf16 first when
    ``round_bf16`` is set: stated by the Function, not left to the
    backward of a cast."""
    rng = np.random.default_rng(22)
    seg_ids, rel = search["seg_ids"], torch.from_numpy(search["rel"])
    values = torch.from_numpy(rng.standard_normal((B, N, 5)).astype(
        np.float32)).requires_grad_()
    out = cb.BucketGather.apply(values, seg_ids, rel, SEG, QBLOCK,
                                round_bf16)
    g = torch.from_numpy(rng.standard_normal(tuple(out.shape)).astype(
        np.float32))
    (got,) = torch.autograd.grad(out, values, g)

    ref_values = values.detach().clone().requires_grad_()
    glob = cb._bucket_rows(seg_ids, rel, seg=SEG, qblock=QBLOCK)
    ref = torch.gather(ref_values, 1,
                       glob.reshape(B, -1, 1).expand(-1, -1, 5))
    g_ref = g.reshape(B, -1, 5)
    if round_bf16:
        g_ref = g_ref.bfloat16().float()
    (want,) = torch.autograd.grad(ref, ref_values, g_ref)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    if round_bf16:
        ref = ref.bfloat16().float()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref.detach().reshape(out.shape).numpy())


def test_gather_bucket_carries_a_gradient(search):
    """Called directly on values that need a gradient, ``gather_bucket``
    goes through ``BucketGather`` rather than drop it."""
    values = torch.ones((B, N, 3), requires_grad=True)
    kw = dict(seg=SEG, qblock=QBLOCK, round_bf16=False)
    rel = torch.from_numpy(search["rel"])
    out = cb.gather_bucket(values, search["seg_ids"], rel, **kw)
    assert out.grad_fn is not None
    (grad,) = torch.autograd.grad(out.sum(), values)
    want = cb.gather_bucket_bwd_plain(torch.ones(tuple(out.shape)),
                                      search["seg_ids"], rel, N, **kw)
    assert torch.equal(grad, want)
    with torch.no_grad():
        assert cb.gather_bucket(values, search["seg_ids"], rel,
                                **kw).grad_fn is None


def test_gather_bwd_checks_its_shapes(search):
    seg_ids, rel = search["seg_ids"], torch.from_numpy(search["rel"])
    with pytest.raises(ValueError, match="does not match rel"):
        cb.gather_bucket_bwd(torch.zeros((B, N, K + 1, 3)), seg_ids, rel, N,
                             seg=SEG, qblock=QBLOCK, round_bf16=False)
    with pytest.raises(ValueError, match="bad bucket shapes"):
        cb.gather_bucket_bwd(torch.zeros((B, N, K, 3)), seg_ids, rel, N + 1,
                             seg=SEG, qblock=QBLOCK, round_bf16=False)


def test_float4_units_choice():
    """The gather kernels move 16-byte units only where C is a multiple of
    4 and every row-strided tensor is 16-byte aligned; a view at a storage
    offset of one float is not, and gets 4-byte units."""
    aligned = torch.zeros((B, 64, 64))
    assert cb.float4_units(64, aligned, torch.zeros((B, 8, 4, 64)))
    assert cb.float4_units(128, aligned)
    assert not cb.float4_units(11, torch.zeros((B, 64, 11)))
    assert not cb.float4_units(35, torch.zeros((B, 64, 35)))
    shifted = torch.zeros(B * 64 * 64 + 1)[1:].view(B, 64, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert not cb.float4_units(64, shifted)
    assert not cb.float4_units(64, aligned, shifted)
    # a storage offset of a whole row keeps the alignment
    assert cb.float4_units(64, torch.zeros((B + 1, 64, 64))[1:])


def test_gather_wrappers_pass_the_variant(monkeypatch, search):
    """On the kernel route each wrapper hands its entry point the variant
    that ``float4_units`` picks for its own tensors (values and out, g and
    dvalues), and counts one launch per call."""
    from open3d_ml_tpu_torch.ops.cuda import _build
    calls = []

    class Library:
        def bucket_gather_launch(self, *args):
            calls.append(("gather", args))
            return 0

        def bucket_gather_bwd_launch(self, *args):
            calls.append(("bwd", args))
            return 0

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(cb, "route", lambda t, family: "kernel")
    monkeypatch.setattr(cb, "stream", lambda: 0)
    monkeypatch.setattr(cb, "LAUNCHES", dict.fromkeys(cb.LAUNCHES, 0))
    seg_ids, rel = search["seg_ids"], torch.from_numpy(search["rel"])
    kw = dict(seg=SEG, qblock=QBLOCK, round_bf16=True)
    shifted = torch.zeros(B * N * 64 + 1)[1:].view(B, N, 64)
    for values, vec4 in ((torch.zeros((B, N, 64)), 1),
                         (torch.zeros((B, N, 11)), 0), (shifted, 0)):
        c = values.shape[2]
        cb.gather_bucket(values, seg_ids, rel, **kw)
        g = (torch.zeros((B, N, K, c)) if vec4 or c % 4 else
             torch.zeros(B * N * K * c + 1)[1:].view(B, N, K, c))
        cb.gather_bucket_bwd(g, seg_ids, rel, N, **kw)
        for kind, args in calls[-2:]:
            # ..., C at 8, ..., round_bf16, vec4, stream
            assert (args[8], args[-3], args[-2]) == (c, 1, vec4), kind
    assert cb.LAUNCHES == {"bucket_knn": 0, "bucket_gather": 3,
                           "bucket_gather_bwd": 3}


def test_gather_refuses_rows_past_32_bits():
    """The kernels index rows and value rows with 32-bit integers: more
    than 2^31 - 1 gathered rows are refused on either route."""
    meta = dict(device="meta")
    values = torch.empty((1, 64, 4), **meta)
    seg_ids = torch.empty((1, 2**31 // 128 + 1, 1), dtype=torch.int32,
                          **meta)
    rel = torch.empty((1, 2**31, 1), dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="2147483647"):
        cb.gather_bucket(values, seg_ids, rel, seg=64, qblock=128,
                         round_bf16=False)
    with pytest.raises(ValueError, match="2147483647"):
        cb.gather_bucket_bwd(torch.empty((1, 2**31, 1, 4), **meta), seg_ids,
                             rel, 64, seg=64, qblock=128, round_bf16=False)


def _knn_kernel_route(monkeypatch):
    """Send ``knn_bucket`` down the kernel route on CPU tensors, into a
    fake library that records each launch's arguments and sizes shared
    memory as the kernel library's ``bucket_knn_shared`` does (16 bytes a
    row and a batch of 32 rows of slack)."""
    from open3d_ml_tpu_torch.ops.cuda import _build
    calls = []

    class Library:
        def bucket_knn_launch(self, *args):
            calls.append(args)
            return 0

        def bucket_knn_shared(self, rows):
            return 16 * (rows + 32)

    monkeypatch.setattr(_build, "library", Library)
    monkeypatch.setattr(cb, "route", lambda t, family: "kernel")
    monkeypatch.setattr(cb, "stream", lambda: 0)
    monkeypatch.setattr(cb, "sm_count", lambda index: 132)
    monkeypatch.setattr(cb, "LAUNCHES", dict.fromkeys(cb.LAUNCHES, 0))
    return calls


def test_knn_refuses_a_table_past_shared_memory(monkeypatch):
    """The kernel stages S * seg points (16 bytes each) in one block's
    shared memory, up to the 227 KB a block may opt in to: S 48 x seg 64
    (the training budget, 48 KB) and S 65 x seg 64, past the old 48 KB
    limit, pass on both routes; S 226 x seg 64 (231,936 bytes with the
    slack) is the most the kernel route takes and S 227 is refused
    there."""
    pts = torch.zeros((1, 227 * 64, 3))
    queries = pts[:, :8]
    for s in (48, 65):
        sids = torch.zeros((1, 1, s), dtype=torch.int32)
        cb.knn_bucket(pts, queries, sids, 1, seg=64, qblock=8)
    calls = _knn_kernel_route(monkeypatch)
    for s in (48, 65, 226):
        sids = torch.zeros((1, 1, s), dtype=torch.int32)
        cb.knn_bucket(pts, queries, sids, 1, seg=64, qblock=8)
    assert len(calls) == 3
    with pytest.raises(ValueError, match="232960 bytes of shared memory"):
        cb.knn_bucket(pts, queries,
                      torch.zeros((1, 1, 227), dtype=torch.int32), 1, seg=64,
                      qblock=8)


def test_knn_kernel_route_refuses_what_it_is_not_built_for(monkeypatch):
    """On the kernel route k must be 1 or 16 and seg a power of two (the
    plain version takes any)."""
    pts = torch.zeros((1, 48 * 4, 3))
    sids = torch.zeros((1, 1, 4), dtype=torch.int32)
    cb.knn_bucket(pts, pts[:, :8], sids, 4, seg=48, qblock=8)
    _knn_kernel_route(monkeypatch)
    with pytest.raises(ValueError, match="power of two"):
        cb.knn_bucket(pts, pts[:, :8], sids, 16, seg=48, qblock=8)
    with pytest.raises(ValueError, match="k in"):
        cb.knn_bucket(pts, pts[:, :8], sids, 4, seg=64, qblock=8)
    with pytest.raises(ValueError, match="qblock"):
        cb.knn_bucket(torch.zeros((1, 64 * 4, 3)),
                      torch.zeros((1, 2048, 3)), sids, 16, seg=64,
                      qblock=2048)


# the fused pyramid's levels at the shipped config: (points, S) at the
# inference budget S32 and the training budget S48, seg 64, qblock 128
FUSED_LEVELS = {32: ((45_056, 32), (11_264, 32), (2_816, 32), (704, 11)),
                48: ((45_056, 48), (11_264, 48), (2_816, 44), (704, 11))}


@pytest.mark.parametrize("budget", sorted(FUSED_LEVELS))
def test_knn_bucket_plan_splits_within_one_wave(monkeypatch, budget):
    """At every neighbour search of the fused pyramid (B = 4) a query
    block's table is split over the most blocks, up to 8, that keep the
    grid within one block per SM of 132: levels 0-2 (88 query blocks or
    more) are not split, level 3 (24) is split 5 ways. Each query block's
    table positions are split into slices that cover every position
    exactly once; a block's threads hold its qblock queries; its shared
    memory is the library's size of its slice. Level 3's pool search (176
    queries, 2 query blocks) is split 8 ways."""
    _knn_kernel_route(monkeypatch)
    for n, s in FUSED_LEVELS[budget]:
        plan = cb.knn_bucket_plan(4, n, s, 64, 128, sms=132)
        nqb = -(-n // 128)
        assert plan["groups"] == max(1, min(cb.KNN_MAX_GROUPS,
                                            132 // (4 * nqb))), (n, plan)
        assert plan["groups"] == 1 or 4 * nqb * plan["groups"] <= 132
        rows = s * 64
        cover = sorted(p for g in range(plan["groups"])
                       for p in range(g * plan["span"],
                                      min(rows, (g + 1) * plan["span"])))
        assert cover == list(range(rows))
        assert plan["threads"] % 32 == 0
        assert plan["threads"] * plan["qpt"] >= 128
        assert plan["shared"] == 16 * (plan["span"] + 32)
    assert [cb.knn_bucket_plan(4, n, s, 64, 128, sms=132)["groups"]
            for n, s in FUSED_LEVELS[budget]] == [1, 1, 1, 5]
    pool = cb.knn_bucket_plan(4, 176, 11, 64, 128, sms=132)
    assert (pool["groups"], pool["span"]) == (8, 88)
    # a block has at most 512 threads: a query block of 1,024 takes two
    # queries a thread
    wide = cb.knn_bucket_plan(1, 4096, 4, 64, 1024, sms=132)
    assert (wide["qpt"], wide["threads"]) == (2, 512)


def test_knn_bucket_wrapper_passes_the_plan(monkeypatch, search):
    """On the kernel route ``knn_bucket`` hands its entry point seg's
    shift, the plan and its shared memory, and scratch for the blocks'
    lists and zeroed tickets where the plan splits the table; one launch
    per call."""
    calls = _knn_kernel_route(monkeypatch)
    for k in (1, K):
        cb.knn_bucket(search["pcp"], search["sp"], search["seg_ids"], k,
                      seg=SEG, qblock=QBLOCK)
        plan = cb.knn_bucket_plan(B, N, S, SEG, QBLOCK, sms=132)
        args = calls[-1]
        # points, queries, seg_ids, rel, d2, part_i, part_d, tickets, B,
        # npad, Q, nqb, S, seg_shift, qblock, k, qpt, threads, groups, span,
        # shared, stream
        assert args[8:] == (B, search["pcp"].shape[1], N, N // QBLOCK, S, 5,
                            QBLOCK, k, plan["qpt"], plan["threads"],
                            plan["groups"], plan["span"], plan["shared"], 0)
        assert ((args[5] is None) == (args[6] is None) == (args[7] is None)
                == (plan["groups"] == 1))
    assert cb.LAUNCHES == {"bucket_knn": 2, "bucket_gather": 0,
                           "bucket_gather_bwd": 0}


def _bucket_d2(points, queries, seg_ids, *, seg, qblock):
    """[B, nqb, qblock, T] d2 of each (padded) query of a block against its
    table, in the contract's order, and the table positions."""
    b, q, _ = queries.shape
    nqb, s = seg_ids.shape[1:]
    cand = (seg_ids.long()[..., None] * seg + torch.arange(seg)).reshape(b, -1)
    tab = torch.gather(points, 1, cand[..., None].expand(-1, -1, 3))
    tab = tab.reshape(b, nqb, 1, s * seg, 3)
    qs = torch.nn.functional.pad(queries, (0, 0, 0, nqb * qblock - q))
    qs = qs.reshape(b, nqb, qblock, 1, 3)
    dx, dy, dz = (qs[..., i] - tab[..., i] for i in range(3))
    return dx * dx + dy * dy + dz * dz


@pytest.mark.parametrize("strided", [False, True])
@pytest.mark.parametrize("count", [1, 3, 8, 32])
@pytest.mark.parametrize("kind", ["lattice", "uniform"])
def test_knn_table_slices_merged_by_key_equal_the_plain_version(
        search, kind, count, strided):
    """The table positions split into slices (contiguous, as the kernel's
    blocks take them, or strided), each slice's k best by (d2, position),
    merged by the same key: equal to ``knn_bucket_plain`` index for
    index."""
    if kind == "lattice":
        pcp, sp, sids = search["pcp"], search["sp"], search["seg_ids"]
    else:
        rng = np.random.default_rng(31)
        pts = torch.from_numpy(rng.uniform(-10, 10, (B, N, 3))
                               .astype(np.float32))
        _, sp = hilbert_sort(pts)
        sids = tb.select_segments(sp, sp, seg=SEG, qblock=QBLOCK, num_segs=S)
        pcp = tb.pad_seg(sp, SEG, fill=1e9)
    want = cb.knn_bucket_plain(pcp, sp, sids, K, seg=SEG, qblock=QBLOCK)
    d2 = _bucket_d2(pcp, sp, sids, seg=SEG, qblock=QBLOCK)
    pos = torch.arange(d2.shape[-1])
    parts = (pos[p::count] for p in range(count)) if strided else \
        torch.tensor_split(pos, count)
    keys = torch.cat([torch.topk((d2[..., p].view(torch.int32).long() << 32)
                                 | p, min(K, len(p)), dim=-1,
                                 largest=False).values for p in parts], -1)
    top = torch.topk(keys, K, dim=-1, largest=False).values.reshape(B, -1, K)
    assert torch.equal((top & 0xFFFFFFFF).int(), want[0])
    assert torch.equal((top >> 32).int().view(torch.float32), want[1])
