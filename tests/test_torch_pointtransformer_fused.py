"""The port's PointTransformer on the fused path (``knn_method="fused"``)
against the JAX package's.

Inputs are made with numpy from a seed and go through both packages, at
the small config of ``tests/test_models_semseg.py``'s fused test: B = 2,
N = 1,024, blocks [2, 2, 2, 2, 2], seg 32, block 32, S8, G4 (levels of
1,024, 256, 64, 16 and 4 points), and at ``gather_segs`` 0, which reuses
the attention tables for the grouping. On the CPU the JAX bucket kernels
take their XLA twins (``interpret=True``, as the JAX net picks on the
CPU) and the port's wrappers their plain versions.

On the 1/32 lattice every d2 is exact in float32 under the twin's
cross-term formula and the port's direct one, so both pyramids pick the
same neighbours, ties included, and the float32 nets differ by rounding
only. On uniform points the neighbours are compared by their distances and
as sets, which may differ only at near-ties.

In bfloat16 the two sides round at other places: the JAX twins gather
exact values (bf16 in, bf16 out for the attention gather, float32 for the
others), where the port's gathers, as the TPU kernel did, round every
value to bf16 and return float32, so the attention's sums run in float32
on the port and in bf16 on the JAX CPU path. The bound is measured (see
``BF16_REL``).

The weights are the port's seeded initialisation with BN statistics drawn
from numpy, carried to JAX with ``state_dict_to_jax``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from open3d_ml_tpu.models import point_transformer as jpt
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxLoss
from open3d_ml_tpu.ops import bucket as jb
from open3d_ml_tpu.ops.pallas import bucket as pb
from open3d_ml_tpu_torch import run_pipeline
from open3d_ml_tpu_torch.models import PointTransformer
from open3d_ml_tpu_torch.models import point_transformer as tpt
from open3d_ml_tpu_torch.modules.losses import SemSegLoss
from open3d_ml_tpu_torch.ops import bucket as tb
from open3d_ml_tpu_torch.ops.cuda import bucket as cb
from open3d_ml_tpu_torch.ops.morton import hilbert_sort
from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
from open3d_ml_tpu_torch.pipelines.semantic_segmentation import init_weights
from open3d_ml_tpu_torch.utils import load_jax_variables, state_dict_to_jax

import chip_smoke
from test_torch_ops import lattice_cloud
from test_torch_pointtransformer import (PT_SMALL, PT_YML, ROOMS, _close,
                                         _dataset_cfg, _grads_by_port_name,
                                         _rel, write_s3dis)
from test_torch_randlanet import _randomise_stats
from torch_threads import one_torch_thread  # noqa: F401

B, N = 2, 1024
FUSED = dict(blocks=[2, 2, 2, 2, 2], num_points=N, knn_method="fused",
             seg=32, block=32, num_segs=8, gather_segs=4)
PYRAMID = dict(seg=32, qblock=32, num_segs=8)
F32_TOL = 1e-4  # float32 logits: max |difference| over max |logit|
# bfloat16 logits, relative L2 and argmax agreement: measured 5.73e-3 and
# 0.9883 at G4, 5.70e-3 and 0.9800 at G0 (seeds as below)
BF16_REL = 1e-2
BF16_AGREE = 0.97


def _lattice_inputs(seed, b=B, n=N):
    rng = np.random.default_rng(seed)
    return (lattice_cloud(rng, b, n),
            rng.uniform(0, 1, (b, n, 3)).astype(np.float32))


def _uniform_points(seed, b=B, n=N):
    return np.random.default_rng(seed).uniform(-2, 2, (b, n, 3)).astype(
        np.float32)


def _weights(cfg, seed=0):
    """The port net's seeded weights with BN statistics drawn: (its
    state_dict, the same as JAX variables)."""
    net = init_weights(PointTransformer(**cfg).get_net(),
                       torch.Generator().manual_seed(seed))
    variables = state_dict_to_jax(net.state_dict())
    variables["batch_stats"] = _randomise_stats(
        variables["batch_stats"], np.random.default_rng(seed + 1))
    net = load_jax_variables(net, variables)
    return net.state_dict(), variables


# ---------------------------------------------------------------- pyramid

def _pyramids(points, gather_segs):
    jax_pyr = jax.jit(lambda p: jb.build_pt_pyramid_tpu(
        p, tpt.NSAMPLE, tpt.STRIDE[1:], gather_segs=gather_segs,
        up_k=tpt.UP_K, interpret=True, **PYRAMID))(jnp.asarray(points))
    pyr = tb.build_pt_pyramid(torch.from_numpy(points), tpt.NSAMPLE,
                              tpt.STRIDE[1:], gather_segs=gather_segs,
                              up_k=tpt.UP_K, **PYRAMID)
    return jax.tree.map(np.asarray, jax_pyr), pyr


TABLES = [(name, i) for name, levels in (("nbr", 5), ("pool", 4),
                                         ("up", 4)) for i in range(levels)]


@pytest.mark.parametrize("gather_segs", [4, 0])
def test_pyramid_equals_jax_on_lattice_points(gather_segs):
    """Every table of the pyramid equal to ``build_pt_pyramid_tpu``'s on
    lattice points: perm, each level's coordinates, and each attention,
    grouping and upsample table's seg_ids, rel and qblock (level 4's 4
    points a block of 8; the grouping at G0 reuses the attention tables
    from level 1 on, at a quarter of their qblock)."""
    points, _ = _lattice_inputs(1)
    want, got = _pyramids(points, gather_segs)
    np.testing.assert_array_equal(got["perm"].numpy(), want["perm"])
    for i in range(5):
        np.testing.assert_array_equal(got["coords"][i].numpy(),
                                      want["coords"][i])
    for name, i in TABLES:
        for part in ("seg_ids", "rel"):
            np.testing.assert_array_equal(
                got[f"{name}_{part}"][i].numpy(), want[f"{name}_{part}"][i],
                err_msg=f"{name}_{part}[{i}]")
        assert got[f"{name}_qblock"][i] == want[f"{name}_qblock"][i]
    assert got["nbr_qblock"] == [32, 32, 32, 16, 8]
    assert got["pool_qblock"] == ([32, 32, 32, 16] if gather_segs else
                                  [32, 8, 8, 4])
    assert [r.shape[-1] for r in got["nbr_rel"]] == [8, 16, 16, 16, 4]
    assert [r.shape[-1] for r in got["up_rel"]] == [3, 3, 3, 3]


def _neighbour_rows(pyr, name, i):
    """[B, Q, K] rows of the level each table reads, in sorted order."""
    return cb._bucket_rows(torch.from_numpy(np.array(pyr[f"{name}_seg_ids"][i])),
                           torch.from_numpy(np.array(pyr[f"{name}_rel"][i])),
                           seg=PYRAMID["seg"],
                           qblock=int(pyr[f"{name}_qblock"][i])).numpy()


def test_pyramid_matches_jax_on_uniform_points():
    """On uniform points the same perm, coordinates and candidate
    segments; each query's neighbours at the same distances (float64,
    from the coordinates, sorted; 1e-5 relative) and the same set on at
    least 99% of queries in every table (near-ties may swap, and a swap
    may move the compacted slots)."""
    points = _uniform_points(2)
    want, got = _pyramids(points, 4)
    np.testing.assert_array_equal(got["perm"].numpy(), want["perm"])
    levels = [c.numpy().astype(np.float64) for c in got["coords"]]
    for name, i in TABLES:
        src = levels[i + 1] if name == "up" else levels[i]
        qs = levels[i + 1] if name == "pool" else levels[i]
        rows_got, rows_want = (_neighbour_rows(p, name, i)
                               for p in (got, want))
        b = np.arange(B)[:, None, None]
        d_got, d_want = (np.sort(((src[b, r] - qs[:, :, None]) ** 2).sum(-1),
                                 -1) for r in (rows_got, rows_want))
        np.testing.assert_allclose(d_got, d_want, rtol=1e-5, atol=1e-9,
                                   err_msg=f"{name}[{i}]")
        same = (np.sort(rows_got, -1) == np.sort(rows_want, -1)).all(-1)
        assert same.mean() >= 0.99, (name, i, same.mean())


# ------------------------------------------------------------ the search

@pytest.mark.parametrize("kind", ["lattice", "uniform"])
@pytest.mark.parametrize("k", [3, 8])
def test_knn_plain_matches_jax_at_k_3_and_8(k, kind):
    """``knn_bucket_plain`` at PointTransformer's k = 3 (the upsample) and
    8 (level-0 attention) against JAX ``knn_pallas``: on lattice points
    rel and d2 equal; on uniform ones d2 within the twin's cross-term
    residue and the neighbour sets equal on 99.5% of queries (a ragged
    last query block)."""
    rng = np.random.default_rng(3 + k)
    pts = (lattice_cloud(rng, B, N) if kind == "lattice" else
           _uniform_points(4 + k))
    _, sp = hilbert_sort(torch.from_numpy(pts))
    queries = sp[:, ::4][:, :N // 4 - 5].contiguous()
    seg_ids = tb.select_segments(sp, queries, **PYRAMID)
    pcp = tb.pad_seg(sp, PYRAMID["seg"], fill=1e9)
    rel_j, d2_j = (np.asarray(a) for a in pb.knn_pallas(
        jnp.asarray(pcp.numpy()), jnp.asarray(queries.numpy()),
        jnp.asarray(seg_ids.numpy()), k, seg=32, qblock=32, interpret=True))
    rel, d2 = cb.knn_bucket(pcp, queries, seg_ids, k, seg=32, qblock=32)
    assert rel.shape == (B, queries.shape[1], k)
    if kind == "lattice":
        np.testing.assert_array_equal(rel.numpy(), rel_j)
        np.testing.assert_array_equal(d2.numpy(), d2_j)
        return
    np.testing.assert_allclose(d2.numpy(), d2_j, rtol=1e-5, atol=1e-5)
    same = (np.sort(rel.numpy(), -1) == np.sort(rel_j, -1)).all(-1)
    assert same.mean() >= 0.995, same.mean()


# --------------------------------------------------------------- the net

@pytest.fixture(scope="module")
def weights():
    return _weights(FUSED)


def _port_forward(state, cfg, points, feat, train=False):
    net = PointTransformer(**cfg).get_net()
    net.load_state_dict(state)
    net.train(train)
    with torch.no_grad():
        return net({"point": torch.from_numpy(points),
                    "feat": torch.from_numpy(feat)}).numpy()


def _jax_forward(variables, cfg, points, feat):
    net = jpt.PointTransformer(**cfg).get_net()
    return np.asarray(jax.jit(lambda v, b: net.apply(v, b, training=False))(
        variables, {"point": jnp.asarray(points), "feat": jnp.asarray(feat)}))


@pytest.mark.parametrize("gather_segs", [4, 0])
def test_forward_matches_jax(weights, gather_segs):
    """Eval logits in float32 within ``F32_TOL`` of the largest |logit| of
    the JAX fused net's on the same variables (measured ~6e-7), and in
    bfloat16 within ``BF16_REL`` relative L2 with argmax agreement
    ``BF16_AGREE``; the logits in the caller's point order."""
    state, variables = weights
    points, feat = _lattice_inputs(5)
    for dtype in ("float32", "bfloat16"):
        cfg = dict(FUSED, gather_segs=gather_segs, compute_dtype=dtype)
        want = _jax_forward(variables, cfg, points, feat)
        got = _port_forward(state, cfg, points, feat)
        assert got.shape == (B, N, 13)
        if dtype == "float32":
            assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()
        else:
            assert _rel(got, want) <= BF16_REL, _rel(got, want)
            agree = (got.argmax(-1) == want.argmax(-1)).mean()
            assert agree >= BF16_AGREE, agree


def test_forward_launches_and_casts(monkeypatch):
    """One fused forward at the small config searches 13 times (5
    attention, 4 grouping, 4 upsample; k 8, 16, 16, 16, 4 for attention,
    16 for every grouping, 3 for every upsample), as
    ``chip_smoke.pt_fused_searches`` lists them, and gathers 18 times at
    blocks [2, 2, 2, 2, 2] (10 attention reads of 3 + 2 * planes
    channels, one a Bottleneck; 4 groupings of level i's 3 + planes[i]
    onto level i + 1; 4 upsamples of level i + 1's 3 + planes[i], its
    features brought to level i's width); no FPS and no exact search. In bfloat16 every Linear
    but ``cls1`` computes in bf16; in float32 none does."""
    seen = {"knn": [], "gather": [], "exact": 0, "fps": 0}
    real_knn, real_gather = tb.knn_bucket, cb.gather_bucket

    def knn(points, queries, seg_ids, k, **kw):
        seen["knn"].append((points.shape[1], queries.shape[1], k,
                            seg_ids.shape[-1], kw["qblock"]))
        return real_knn(points, queries, seg_ids, k, **kw)

    def gather(values, *args, **kw):
        seen["gather"].append(values.shape[-1])
        return real_gather(values, *args, **kw)

    def count(name):
        def call(*args, **kw):
            seen[name] += 1
        return call

    from open3d_ml_tpu_torch.ops import neighbors, sampling
    monkeypatch.setattr(tb, "knn_bucket", knn)
    monkeypatch.setattr(cb, "gather_bucket", gather)
    monkeypatch.setattr(neighbors, "knn_exact", count("exact"))
    monkeypatch.setattr(sampling, "fps", count("fps"))
    points, feat = _lattice_inputs(6)
    planes = tpt.PLANES
    widths = [3 + 2 * p for p in planes] * 2 + [3 + p for p in planes[:4]] * 2
    real_linear = torch.nn.functional.linear
    for dtype in ("bfloat16", "float32"):
        seen["knn"], seen["gather"], calls = [], [], []
        net = PointTransformer(**dict(FUSED, compute_dtype=dtype)).get_net()
        linears = [m for m in net.modules() if isinstance(m, torch.nn.Linear)]
        with monkeypatch.context() as m:
            # nn.Linear and dense (models/common.py) both call F.linear
            m.setattr(torch.nn.functional, "linear", lambda x, w, b=None: (
                calls.append((tuple(w.shape), x.dtype, w.dtype)),
                real_linear(x, w, b))[1])
            with torch.no_grad():
                net.eval()({"point": torch.from_numpy(points),
                            "feat": torch.from_numpy(feat)})
        assert seen["knn"] == [shape for _, shape in
                               chip_smoke.pt_fused_searches(FUSED, N)]
        assert sorted(s[2] for s in seen["knn"]) == sorted(
            [8, 16, 16, 16, 4] + [16] * 4 + [3] * 4)
        assert sorted(seen["gather"]) == sorted(widths)
        assert seen["exact"] == seen["fps"] == 0
        assert len(calls) == len(linears)
        cls1 = (13, tpt.PLANES[0])
        for shape, x_dt, w_dt in calls:
            want = (torch.bfloat16 if dtype == "bfloat16" and shape != cls1
                    else torch.float32)
            assert x_dt == w_dt == want, (shape, x_dt, w_dt)


def _jax_step(variables, cfg, batch, dtype):
    """The JAX fused net's train-mode (logits, loss, gradients) on
    ``batch`` in ``dtype``."""
    jm = jpt.PointTransformer(**cfg)
    jnet = jm.get_net()
    cast = lambda t: jax.tree.map(lambda v: jnp.asarray(v, dtype), t)
    params, stats = cast(variables["params"]), cast(variables["batch_stats"])
    jbatch = dict(cast({k: batch[k] for k in ("point", "feat")}),
                  label=jnp.asarray(batch["label"]))
    jloss = JaxLoss(None, jm, _dataset_cfg())

    def loss_fn(p):
        out, _ = jnet.apply({"params": p, "batch_stats": stats}, jbatch,
                            training=True, mutable=["batch_stats"])
        return jm.get_loss(jloss, out, jbatch)[0], out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(params)
    return jax.tree.map(np.asarray, (out, loss, grads))


def test_train_step_matches_jax(weights):
    """One train-mode fused step (compute_dtype float32) against
    ``jax.value_and_grad`` of the JAX fused net, both packages in float64
    (the pyramid searched on the float32 coordinates, exact on the
    lattice): the logits, the loss and every gradient within
    ``_close``'s 1e-6 relative L2 (measured: logits 1.9e-13). In float32
    the train-mode logits lie 9.4e-5 from JAX's float32 ones and the loss
    1.3e-6 (batch statistics over level 4's 8 rows amplify rounding), so
    the port's float32 step is held to the float64 one at 3e-4 and 1e-5
    only."""
    state, variables = weights
    points, feat = _lattice_inputs(7)
    labels = np.random.default_rng(8).integers(0, 13, (B, N)).astype(
        np.int32)
    batch = {"point": points, "feat": feat, "label": labels}
    cfg = dict(FUSED, compute_dtype="float32")
    with jax.enable_x64(True):
        out, loss, grads = _jax_step(variables, cfg, batch, jnp.float64)
    tm = PointTransformer(**cfg)
    net = tm.get_net()
    net.load_state_dict(state)
    net = net.train().double()
    got = net({k: torch.from_numpy(batch[k]).double()
               for k in ("point", "feat")})
    got_loss, _, _ = tm.get_loss(SemSegLoss(None, tm, _dataset_cfg()), got,
                                 {"label": torch.from_numpy(labels)})
    assert got.dtype == torch.float64
    _close(got.detach().numpy(), out, "logits")
    assert abs(got_loss.item() - float(loss)) <= 1e-6 * abs(float(loss))
    got_loss.backward()
    want = dict(_grads_by_port_name(grads))
    named = dict(net.named_parameters())
    assert set(named) == set(want)
    for key, p in named.items():
        _close(p.grad.numpy(), want[key], key)

    net32 = tm.get_net()
    net32.load_state_dict(state)
    got32 = net32.train()({k: torch.from_numpy(batch[k])
                           for k in ("point", "feat")})
    loss32, _, _ = tm.get_loss(SemSegLoss(None, tm, _dataset_cfg()), got32,
                               {"label": torch.from_numpy(labels)})
    assert _rel(got32.detach().numpy(), out) <= 3e-4
    assert abs(loss32.item() - float(loss)) <= 1e-5 * float(loss)


def test_bf16_step_has_finite_gradients(weights):
    """The bfloat16 fused step: a finite loss, and a finite gradient on
    every parameter, reaching every Linear weight, through the gathers'
    backward (``BucketGather``)."""
    state, _ = weights
    points, feat = _lattice_inputs(9)
    tm = PointTransformer(**FUSED)
    net = tm.get_net()
    net.load_state_dict(state)
    out = net.train()({"point": torch.from_numpy(points),
                       "feat": torch.from_numpy(feat)})
    labels = torch.from_numpy(np.random.default_rng(10).integers(
        0, 13, (B, N)).astype(np.int32))
    loss, _, _ = tm.get_loss(SemSegLoss(None, tm, _dataset_cfg()), out,
                             {"label": labels})
    loss.backward()
    assert torch.isfinite(loss)
    for name, p in net.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        if name.endswith("weight") and p.dim() == 2:
            assert p.grad.abs().sum() > 0, name


def test_fused_and_exact_nets_share_one_state_dict(weights):
    """``get_net`` (fused) and ``get_eval_net`` (exact) have the same
    parameters and buffers by name and shape; the eval net takes the
    fused net's state and runs; ``eval_knn_method: fused`` gives the fused
    net with a warning."""
    state, _ = weights
    model = PointTransformer(**FUSED)
    net, eval_net = model.get_net(), model.get_eval_net()
    assert net.knn_method == "fused" and eval_net.knn_method == "exact"
    assert ({k: v.shape for k, v in net.state_dict().items()} ==
            {k: v.shape for k, v in eval_net.state_dict().items()})
    eval_net.load_state_dict(state)
    points, feat = _lattice_inputs(11)
    with torch.no_grad():
        out = eval_net.eval()({"point": torch.from_numpy(points),
                               "feat": torch.from_numpy(feat)})
    assert torch.isfinite(out).all()
    fused_eval = PointTransformer(**dict(FUSED, eval_knn_method="fused"))
    assert fused_eval.get_eval_net().knn_method == "fused"


def test_knn_plan_holds_at_the_full_width_pyramid(monkeypatch):
    """The 13 searches of a fused forward at 2 x 16,384 (the shipped
    config: seg 64, block 128, S64; ``chip_smoke.pt_fused_searches``)
    through a stand-in kernel library on the kernel route: each is taken
    (k 3, 8 and 16) with the plan's groups, span and shared memory; the
    level-0 attention's table of 4,096 rows stages 66,048 bytes (past the
    48 KB default, within a block's limit) unsplit; the deeper searches
    split their tables over 2 or 8 blocks; a split call's lists hold
    ``knn_list(k)`` entries (4 at k = 3)."""
    from test_torch_ops import _knn_kernel_route
    calls = _knn_kernel_route(monkeypatch)
    parts = []
    real = cb.partials

    def partials(groups, shape, tickets, device):
        parts.append((groups, shape))
        return real(groups, shape, tickets, device)

    monkeypatch.setattr(cb, "partials", partials)
    cfg = chip_smoke.POINTTRANSFORMER_S3DIS
    searches = chip_smoke.pt_fused_searches(
        dict(cfg, knn_method="fused"), cfg["num_points"])
    for _, (npad, q, k, s, qblock) in searches:
        cb.knn_bucket(torch.zeros((2, npad, 3)), torch.zeros((2, q, 3)),
                      torch.zeros((2, -(-q // qblock), s),
                                  dtype=torch.int32), k, seg=64,
                      qblock=qblock)
    assert len(calls) == len(parts) == 13
    plans = [cb.knn_bucket_plan(2, q, s, 64, qblock, sms=132)
             for _, (_, q, _, s, qblock) in searches]
    for (_, (_, q, k, _, _)), plan, args, (groups, shape) in zip(
            searches, plans, calls, parts):
        assert args[15] == k and args[18:21] == (
            plan["groups"], plan["span"], plan["shared"])
        assert groups == plan["groups"] and shape == (2, q, cb.knn_list(k))
        assert plan["shared"] <= 232_448
    assert (plans[0]["shared"], plans[0]["groups"]) == (66_048, 1)
    assert [p["groups"] for p in plans] == [1, 2, 1, 2, 8, 2, 8, 8, 8, 8, 8,
                                            2, 2]
    assert [k for _, (_, _, k, _, _) in searches] == [8, 16, 3, 16, 16, 3,
                                                      16, 16, 3, 16, 16, 3,
                                                      16]
    assert [cb.knn_list(k) for k in (1, 3, 8, 16)] == [1, 4, 8, 16]


# ------------------------------------------------------- the command line

def test_cli_trains_fused_on_s3dis_rooms(tmp_path, monkeypatch):
    """``--split train --model.knn_method fused`` from the port's YAML on
    an S3DIS tree: one step of 2 and a validation step, at 512-point
    patches (levels of 512 to 2 points) through the fused net in bf16,
    no FPS and no exact search on either; the net at blocks [1, 1, 1, 1,
    1] (a list the command line cannot override)."""
    write_s3dis(tmp_path / "s3dis", ROOMS)
    real = tpt.PointTransformer.get_net
    nets = []

    def small_net(self, knn_method=None):
        self.cfg["blocks"] = [1, 1, 1, 1, 1]
        nets.append(real(self, knn_method))
        return nets[-1]

    monkeypatch.setattr(tpt.PointTransformer, "get_net", small_net)
    from open3d_ml_tpu_torch.ops import neighbors, sampling
    exact = []
    monkeypatch.setattr(neighbors, "knn_exact",
                        lambda *a, **k: exact.append(1))
    monkeypatch.setattr(sampling, "fps", lambda *a, **k: exact.append(1))
    losses = {"train": [], "eval": []}
    for name in ("_train_step", "_eval_step"):
        real_step = getattr(SemanticSegmentation, name)

        def step(self, inputs, loss_fn, real_step=real_step,
                 key="train" if name == "_train_step" else "eval"):
            loss, cm = real_step(self, inputs, loss_fn)
            losses[key].append(float(loss))
            return loss, cm

        monkeypatch.setattr(SemanticSegmentation, name, step)
    run_pipeline.main(["-c", str(PT_YML), "--device", "cpu",
                       "--dataset.dataset_path", str(tmp_path / "s3dis"),
                       "--main_log_dir", str(tmp_path / "logs"),
                       "--split", "train", "--model.knn_method", "fused",
                       *PT_SMALL])
    assert nets[0].knn_method == "fused" and nets[0].cdt == torch.bfloat16
    assert nets[1].knn_method == "exact"  # the eval net, for run_test
    ckpt = (tmp_path / "logs" / "PointTransformer_S3DIS_torch" /
            "checkpoint" / "ckpt_00000.pth")
    assert ckpt.exists()
    assert len(losses["train"]) == 1 and len(losses["eval"]) == 1
    assert np.isfinite(losses["train"] + losses["eval"]).all()
    assert not exact


# ------------------------------------------------------------- full width

@pytest.mark.slow
def test_full_width_forward_matches_jax():
    """The shipped net (blocks [2, 3, 4, 6, 3], seg 64, block 128, S64,
    G32) at 2 x 16,384 lattice points, float32: eval logits within
    ``F32_TOL`` of the largest |logit| of the JAX fused net's (minutes on
    the CPU)."""
    cfg = dict(blocks=[2, 3, 4, 6, 3], num_points=16384, knn_method="fused",
               compute_dtype="float32")
    state, variables = _weights(cfg, seed=20)
    points, feat = _lattice_inputs(21, n=16384)
    want = _jax_forward(variables, cfg, points, feat)
    got = _port_forward(state, cfg, points, feat)
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def test_chip_smoke_pt_fused_constants():
    """``chip_smoke.py``'s fused phase expects, at the shipped blocks [2,
    3, 4, 6, 3], one ``bucket_knn`` launch a search of
    ``pt_fused_searches`` (13) and one ``bucket_gather`` a read (a
    Bottleneck's attention at each of its level's blocks, 4 groupings, 4
    upsamples: 26), and a step one backward a read."""
    cfg = dict(chip_smoke.POINTTRANSFORMER_S3DIS, knn_method="fused")
    reads = sum(cfg["blocks"]) + 2 * 4
    assert chip_smoke.PT_FUSED_FORWARD_LAUNCHES == {
        "bucket_knn": len(chip_smoke.pt_fused_searches(
            cfg, cfg["num_points"])), "bucket_gather": reads}
    assert chip_smoke.PT_FUSED_STEP_LAUNCHES == dict(
        chip_smoke.PT_FUSED_FORWARD_LAUNCHES, bucket_gather_bwd=reads)
    assert reads == 26
