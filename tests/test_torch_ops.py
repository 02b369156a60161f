"""The port's point ops (``open3d_ml_tpu_torch/ops``) against the JAX package.

Both sides get the same numpy inputs. The JAX bucket kernels run as the JAX
package's own tests run them on the CPU (``interpret=True``: their XLA
twins); the port's kernel wrappers take their plain versions for CPU
tensors.

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
    assert cb.LAUNCHES == {"bucket_knn": 0, "bucket_gather": 0}


def test_entry_points_match_the_sources():
    """The ctypes argument lists agree with the C entry points of the
    CUDA sources (a mismatch would pass garbage, and nothing here compiles
    them)."""
    import re
    from open3d_ml_tpu_torch.ops.cuda import _build
    kinds = {}
    for name in _build.SOURCES:
        text = (_build.CSRC / name).read_text()
        for fn, args in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds[fn] = ["p" if "*" in a else "i" for a in args.split(",")]
    assert set(kinds) == set(_build.ENTRY_POINTS)
    for fn, argtypes in _build.ENTRY_POINTS.items():
        assert kinds[fn] == ["p" if t is _build._P else "i"
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
