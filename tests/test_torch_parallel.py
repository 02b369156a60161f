"""The port's data parallelism (``open3d_ml_tpu_torch.parallel``) on the
CPU: two ranks of a ``gloo`` group, each a process of
``_torch_parallel_worker.py``, against one process and against the JAX
package's one program over the global batch.

The JAX package's contract: a data-parallel step is one program over the
global batch (its loss and normalisers, its BatchNorm statistics, one set
of parameters). So the port's step on 2 ranks of 4 rows each must equal
its one-process step on the 8 rows, and the JAX pipeline's step on the 8
rows sharded over the 8 virtual CPU devices of ``conftest.py``, on the
same weights: RandLA-Net (``SemanticSegmentation._make_train_step``, the
JAX net's dropout mask captured and fed to both port runs, as
``test_torch_train.py`` does) and PointPillars at the JAX dry run's
config (``ObjectDetection._make_train_step``), in float32. Every rank is
spawned once for all cases (``ranks``) and each spawn is bounded by
``communicate(timeout=...)``.
"""

import os
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import optax
import pytest
import torch
from flax.core import FrozenDict

from open3d_ml_tpu.models.point_pillars import PointPillars as JaxPointPillars
from open3d_ml_tpu.models.randlanet import RandLANet as JaxRandLANet
from open3d_ml_tpu.modules.losses import SemSegLoss as JaxSemSegLoss
from open3d_ml_tpu.modules.schedulers import (
    exponential_lr as jax_exponential_lr)
from open3d_ml_tpu.parallel import replicate as jax_replicate
from open3d_ml_tpu.pipelines.object_detection import (
    ObjectDetection as JaxObjectDetection)
from open3d_ml_tpu.pipelines.semantic_segmentation import (
    SemanticSegmentation as JaxSemanticSegmentation, TrainState)
from open3d_ml_tpu.utils import Config as JaxConfig
from open3d_ml_tpu_torch.models import PointPillars, RandLANet
from open3d_ml_tpu_torch.parallel import dryrun, mesh
from open3d_ml_tpu_torch.utils import load_jax_variables
from open3d_ml_tpu_torch.utils.convert_jax import jax_to_state_dict

import _torch_parallel_worker as worker
from test_torch_ops import lattice_cloud
from test_torch_pointpillars import jax_variables
from test_torch_randlanet import _randomise_stats
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_parallel_worker.py"
B = 8  # the global batch: 4 rows a rank
RANKS = 2
SPAWN_TIMEOUT = 300
CASES = ("mesh", "bn", "dryrun", "refuse", "randla", "randla64",
         "randla_odd", "pp")
LR = worker.RANDLA_PIPELINE["optimizer"]["lr"]
PP_LR = 1e-3  # the port's and the JAX package's AdamW default


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(workdir, cases, ranks=RANKS, timeout=SPAWN_TIMEOUT):
    """Run ``cases`` on ``ranks`` worker processes with torchrun's
    environment; every rank must exit 0 within ``timeout`` seconds.
    Returns {case: [rank 0's result, rank 1's, ...]}."""
    port = free_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(ranks),
                   LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), str(workdir), *cases], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, (_, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank}:\n{err[-4000:]}"
    return {case: [torch.load(Path(workdir) / f"{case}_{rank}.pt",
                              weights_only=False) for rank in range(ranks)]
            for case in cases}


def _dataset(config):
    """A stand-in dataset that carries only the class counts."""
    return types.SimpleNamespace(
        cfg=config({"class_weights": worker.CLASS_COUNTS}), name="counts")


def randla_batch():
    rng = np.random.default_rng(21)
    n = worker.RANDLA_SMALL["num_points"]
    return {"coords": lattice_cloud(rng, B, n),
            "features": rng.uniform(-1, 1, (B, n, 3)).astype(np.float32),
            "labels": rng.integers(0, 19, (B, n)).astype(np.int32)}


def _jax_randla(batch, tmp):
    """The JAX pipeline's train step on ``batch`` sharded over the 8
    devices: the variables (BN statistics drawn), the dropout keep mask
    of its key, the loss, the confusion matrix, and the updated
    parameters and statistics as port state dicts."""
    jmodel = JaxRandLANet(**worker.RANDLA_SMALL)
    net = jmodel.get_net()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(0)
    variables = jax.tree.map(np.asarray, jax.jit(
        lambda b: net.init({"params": key, "dropout": key}, b,
                           training=False))(jbatch))
    variables = {"params": variables["params"],
                 "batch_stats": _randomise_stats(variables["batch_stats"],
                                                 np.random.default_rng(22))}
    dropout_key = jax.random.PRNGKey(7)
    _, inter = jax.jit(lambda v, b: net.apply(
        v, b, training=True, mutable=["batch_stats", "intermediates"],
        rngs={"dropout": dropout_key},
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout)))(
            variables, jbatch)
    (dropped,) = jax.tree.leaves(inter["intermediates"])

    pipe = JaxSemanticSegmentation(jmodel, main_log_dir=str(tmp))
    tx = optax.adam(jax_exponential_lr(
        LR, worker.RANDLA_PIPELINE["scheduler_gamma"],
        steps_per_epoch=worker.RANDLA_PIPELINE["steps_per_epoch"]))
    state = jax_replicate(TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        step=jnp.zeros((), jnp.int32), consts=FrozenDict()), pipe.mesh)
    step = pipe._make_train_step(
        JaxSemSegLoss(None, jmodel, _dataset(JaxConfig)), tx)
    dev_batch = pipe._device_batch({"data": batch})
    assert len(dev_batch["coords"].sharding.device_set) == 8
    new, loss, cm = step(state, dev_batch, dropout_key)
    new = jax.tree.map(np.asarray, {"params": new.params,
                                    "batch_stats": new.batch_stats})
    return {"variables": variables, "keep": np.asarray(dropped) != 0,
            "loss": float(loss), "cm": np.asarray(cm),
            "params": jax_to_state_dict({"params": new["params"]}),
            "stats": jax_to_state_dict({"batch_stats":
                                        new["batch_stats"]})}


def _jax_pp(batch, tmp):
    """The JAX pipeline's PointPillars train step (float32, the dry run's
    config) from drawn variables on ``batch``, twice: as one program on
    one device (``one``) and sharded over the 8 devices (``sharded``)."""
    jmodel = JaxPointPillars(compute_dtype="float32",
                             **dryrun.POINTPILLARS_DRYRUN)
    pipe = JaxObjectDetection(jmodel, main_log_dir=str(tmp))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jax_variables(pipe.net, jbatch, training=False)
    tx = optax.adamw(PP_LR, b1=0.95, b2=0.99, weight_decay=0.01)
    step = pipe._make_train_step(tx)
    sharded = pipe._device_batch({"data": batch})
    assert len(sharded["point"].sharding.device_set) == 8
    out = {"variables": variables}
    for name, dev_batch, place in (
            ("one", jbatch, lambda state: state),
            ("sharded", sharded, lambda state: jax_replicate(state,
                                                             pipe.mesh))):
        state = place(TrainState(
            params=variables["params"],
            batch_stats=variables["batch_stats"],
            opt_state=tx.init(variables["params"]),
            step=jnp.zeros((), jnp.int32)))
        new, loss, losses = step(state, dev_batch, jax.random.PRNGKey(3))
        out[name] = {"loss": float(loss),
                     "losses": {k: float(v) for k, v in losses.items()},
                     "state": jax_to_state_dict(
                         jax.tree.map(np.asarray, {
                             "params": new.params,
                             "batch_stats": new.batch_stats}),
                         **_pp_layout())}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX steps, the port's one-process steps and every case on 2
    ranks."""
    tmp = tmp_path_factory.mktemp("parallel")
    batch = randla_batch()
    jax_randla = _jax_randla(batch, tmp / "jax_randla")
    randla_state = load_jax_variables(
        RandLANet(**worker.RANDLA_SMALL).get_net(),
        jax_randla["variables"]).state_dict()
    pp_batch = dryrun.pointpillars_batch(B)
    jax_pp = _jax_pp(pp_batch, tmp / "jax_pp")
    pp_net = PointPillars(compute_dtype="float32",
                          **dryrun.POINTPILLARS_DRYRUN).get_net()
    pp_state = load_jax_variables(pp_net, jax_pp["variables"]).state_dict()
    inputs = {"randla_state": randla_state, "randla_batch": batch,
              "randla_keep": torch.from_numpy(jax_randla["keep"]),
              "pp_state": pp_state, "pp_batch": pp_batch}
    torch.save(inputs, tmp / "inputs.pt")
    ranks = spawn(tmp, CASES)
    # the ranks' thread count: the same sums in the same order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        keep = inputs["randla_keep"]
        one = {"randla": worker.randla_step(inputs, batch, keep),
               "randla64": worker.randla_step(inputs, batch, keep,
                                              torch.float64),
               "randla_odd": worker.randla_step(
                   inputs, {k: v[:3] for k, v in batch.items()}, None),
               "pp": worker.pp_step(inputs, pp_batch)}
    finally:
        torch.set_num_threads(threads)
    return {"jax_randla": jax_randla, "jax_pp": jax_pp, "ranks": ranks,
            "one": one}


def rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _flat(tensors):
    return np.concatenate([np.asarray(t, np.float64).ravel()
                           for t in tensors])


def assert_ranks_equal(results):
    """Every rank holds the same state: its parameters and statistics bit
    for bit (one all-reduce gave each the same gradient sum)."""
    first = results[0]["state"]
    for other in results[1:]:
        for key, value in first.items():
            assert torch.equal(other["state"][key], value), key


def assert_adam_moved_alike(got, want, grads, lr, share=1e-2):
    """Adam's first step moves a weight by lr * g / (|g| + eps) (plus
    AdamW's decay, alike on both sides): by lr times the sign of g where
    |g| >> eps. Where |g| exceeds ``share`` of its tensor's largest entry
    and 1e-6, the two states agree within 1e-6; elsewhere, where float32
    noise may flip the sign of g, within 2 lr. At least 85% of the
    entries are of the first kind. The float32 step of the RandLA batch
    is 3.0e-4 (relative L2) from its float64 step (max-pool and LeakyReLU
    branches that rounding decides), enough to flip entries up to 0.4% of
    a tensor's largest (measured); hence the default 1%."""
    determined = total = 0
    for name, g in grads.items():
        a, b, g = got[name].numpy(), np.asarray(want[name]), g.numpy()
        big = np.abs(g) > max(1e-6, share * np.abs(g).max())
        determined += int(big.sum())
        total += big.size
        np.testing.assert_allclose(a[big], b[big], rtol=0, atol=1e-6,
                                   err_msg=name)
        assert np.abs(a - b).max() <= 2 * lr * (1 + 1e-6), name
    assert determined > 0.85 * total


# ------------------------------------------------------------ the helpers


def test_mesh_at_world_size_one():
    """Outside a group: one rank, nothing split, every helper the
    identity."""
    m = mesh.make_mesh()
    assert m == mesh.Mesh(1, 0)
    data = worker.mesh_batch(8)
    assert mesh.shard_batch(data, m) is data
    assert mesh.batch_rows(8, m) is None
    obj = {"a": 1}
    assert mesh.process_allgather(obj) is obj
    state = {"w": torch.ones(2)}
    assert mesh.replicate(state, m) is state
    with mesh.split(m, 8) as is_split:
        assert not is_split and mesh.current_split() is None
        one = torch.tensor(3.0)
        assert mesh.global_sum(one) is one
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        mesh.make_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="data axis"):
        mesh.make_mesh(data_parallel=2)
    with pytest.raises(RuntimeError, match="torchrun"):
        saved = {k: os.environ.pop(k) for k in mesh.RANK_ENV
                 if k in os.environ}
        try:
            mesh.init_distributed("gloo", "cpu")
        finally:
            os.environ.update(saved)


def test_mesh_helpers_on_two_ranks(runs):
    """shard_batch keeps rank r's rows of 8 (arrays, each pyramid level,
    per-sample lists) and all 3 of a batch that does not divide;
    replicate gives rank 0's state; process_allgather is in rank order;
    the differentiable sum's backward sums the cotangents; global_sum
    sums only under a split batch; reduce_gradients sums."""
    res = runs["ranks"]["mesh"]
    full8, full3 = worker.mesh_batch(8), worker.mesh_batch(3)
    for rank, out in enumerate(res):
        assert out["mesh"] == (RANKS, rank) and out["made"] == out["mesh"]
        rows = slice(4 * rank, 4 * rank + 4)
        got = out["shard8"]
        np.testing.assert_array_equal(got["coords"], full8["coords"][rows])
        for level, want in zip(got["levels"], full8["levels"]):
            np.testing.assert_array_equal(level, want[rows])
        assert got["names"] == full8["names"][rows]
        assert got["calib"] is None
        got = out["shard3"]
        np.testing.assert_array_equal(got["coords"], full3["coords"])
        assert got["names"] == full3["names"]
        assert out["gather"] == [{"rank": 0}, {"rank": 1}]
        assert torch.equal(out["replicated"]["w"], torch.full((2, 3), 1.0))
        assert torch.equal(out["replicated"]["n"], torch.tensor([5]))
        assert torch.equal(out["sum"], torch.full((3,), 3.0))
        assert torch.equal(out["sum_grad"], torch.full((3,), 5.0))
        assert float(out["global_outside"]) == rank + 1
        assert float(out["global_inside"]) == 3.0 and out["is_split"]
        assert not out["odd_split"]
        assert torch.equal(out["grad"], torch.arange(4.0) * 3)


def test_dropout_draws_the_global_mask(runs):
    """Under a split batch each rank keeps its rows of the mask that one
    process draws for the whole batch from the same seed."""
    from open3d_ml_tpu_torch.models.common import Dropout
    want = Dropout(0.5, seed=3).train()(torch.ones(8, 5, 3))
    got = torch.cat([out["dropout"] for out in runs["ranks"]["mesh"]])
    assert torch.equal(got, want)
    assert 0 < int((want == 0).sum()) < want.numel()


@pytest.mark.parametrize("kind", ["last", "nchw", "pillars"])
def test_synced_batchnorm_equals_one_process(runs, kind):
    """float64: 2 ranks x half the batch give the one-process BatchNorm on
    the whole batch, forward and backward: outputs and input gradients
    row for row, the summed weight and bias gradients and the running
    statistics on every rank, within 1e-12 relative L2. "pillars": the
    pillar net's layout, each rank's rows with the one zero pad row the
    batch holds (``shared_rows``), counted once; its cotangent is the sum
    of the ranks'."""
    data = worker.bn_inputs()
    x, cot = data[kind]
    pad = data["pad_cot"].sum(0) if kind == "pillars" else None
    want = worker.bn_step(kind, x, cot, pad)
    res = [out[kind] for out in runs["ranks"]["bn"]]
    got_out = torch.cat([r["out"][:r["dx"].shape[0]] for r in res])
    assert rel_l2(got_out, want["out"][:x.shape[0]]) <= 1e-12
    if kind == "pillars":
        for r in res:  # the pad row's output: relu(BN(0)) before the relu
            assert rel_l2(r["out"][-1], want["out"][-1]) <= 1e-12
    assert rel_l2(torch.cat([r["dx"] for r in res]), want["dx"]) <= 1e-12
    for r in res:
        for key in ("dw", "db", "mean", "var"):
            assert rel_l2(r[key], want[key]) <= 1e-12, key


def test_dryruns_on_two_ranks_equal_one_process(runs):
    """``dryrun_train_step`` and ``dryrun_objdet_step`` give one loss on
    every rank, the one-process loss within 1e-3 relative (both nets
    compute in bfloat16, where float32 rounding of the BatchNorm
    statistics moves a bf16 rounding now and then) and finite."""
    res = runs["ranks"]["dryrun"]
    want = {"train": dryrun.dryrun_train_step(device="cpu"),
            "objdet": dryrun.dryrun_objdet_step(device="cpu")}
    for key, value in want.items():
        assert np.isfinite(value)
        assert res[0][key] == res[1][key], key
        assert rel(res[0][key], value) <= 1e-3, key


def test_other_models_refuse_two_ranks(runs):
    """A model whose data parallelism is not ported raises on 2 ranks,
    naming its ROADMAP entry."""
    for out in runs["ranks"]["refuse"]:
        assert out["error"] and "queue 1 item 7" in out["error"]
        assert "SparseConvUnet" in out["error"]


# ------------------------------------------------------------ RandLA-Net


def test_randla_two_ranks_equal_one_process(runs):
    """The port's step on 2 x 4 rows and on the 8 rows in one process, in
    float64 (where no branch is within rounding): the loss, every summed
    gradient, the BatchNorm statistics and the Adam-updated parameters
    within 1e-6 relative L2 (the loss's divisor sums float32 class
    weights, 4,096 a rank, then the two sums: measured 7e-8 from one sum
    of 8,192; a gradient 0 in exact arithmetic within 1e-12), the Adam
    step as ``assert_adam_moved_alike`` says wherever |g| > 1e-6, the
    confusion matrix exact; in float32, the
    loss within 1e-6 relative, the confusion matrix exact, the statistics
    within 1e-6 of each tensor's largest entry and the Adam step as
    ``assert_adam_moved_alike`` says. Both ranks hold the same state."""
    for case in ("randla64", "randla"):
        assert_ranks_equal(runs["ranks"][case])
    res, one = runs["ranks"]["randla64"], runs["one"]["randla64"]
    got = res[0]
    assert got["state"]["fc0.weight"].dtype == torch.float64
    assert rel(got["loss"], one["loss"]) <= 1e-6
    assert torch.equal(got["cm"], one["cm"])
    for name, want in one["grads"].items():
        diff = np.linalg.norm(got["grads"][name] - want)
        assert diff <= 1e-6 * np.linalg.norm(want) + 1e-12, name
    for key, want in one["state"].items():
        if key.endswith(("running_mean", "running_var")):
            assert rel_l2(got["state"][key], want) <= 1e-6, key
    # float64: every gradient above 1e-6 is determined
    assert_adam_moved_alike(got["state"], one["state"], one["grads"], LR,
                            share=0.0)

    res, one = runs["ranks"]["randla"], runs["one"]["randla"]
    for out in res:
        assert rel(out["loss"], one["loss"]) <= 1e-6
        assert torch.equal(out["cm"], one["cm"])
    for key, want in one["state"].items():
        if key.endswith(("running_mean", "running_var")):
            err = (res[0]["state"][key] - want).abs().max()
            assert err <= 1e-6 * want.abs().max(), key
    assert_adam_moved_alike(res[0]["state"], one["state"], one["grads"],
                            LR)


def test_randla_two_ranks_equal_jax(runs):
    """The port's step on 2 x 4 rows against the JAX pipeline's step on
    the 8 rows sharded over 8 devices, the same weights and dropout mask:
    the loss within 1e-5 relative, the confusion matrix exact, the
    BatchNorm statistics within 1e-6 of each tensor's largest entry, the
    Adam-updated parameters as ``assert_adam_moved_alike`` says."""
    res, ref = runs["ranks"]["randla"], runs["jax_randla"]
    assert rel(res[0]["loss"], ref["loss"]) <= 1e-5
    np.testing.assert_array_equal(res[0]["cm"].numpy(), ref["cm"])
    state = res[0]["state"]
    assert ref["stats"]
    for key, want in ref["stats"].items():
        want = want.numpy()
        err = np.abs(state[key].numpy() - want).max()
        assert err <= 1e-6 * np.abs(want).max(), key
    assert set(ref["params"]) == set(res[0]["grads"])
    assert_adam_moved_alike(state, {k: v.numpy() for k, v in
                                    ref["params"].items()},
                            res[0]["grads"], LR)


def test_randla_batch_that_does_not_divide(runs):
    """3 rows on 2 ranks: every rank runs all 3 with no reduction, and
    its step equals the one-process step bit for bit (the net's own
    dropout, drawn for the whole batch)."""
    res, one = runs["ranks"]["randla_odd"], runs["one"]["randla_odd"]
    for out in res:
        assert torch.equal(out["loss"], one["loss"])
        assert torch.equal(out["cm"], one["cm"])
        for key, value in one["state"].items():
            assert torch.equal(out["state"][key], value), key


# ----------------------------------------------------------- PointPillars


def _pp_stats(state):
    return [k for k in state if k.endswith(("running_mean", "running_var"))]


def test_pointpillars_two_ranks_equal_one_process_and_jax(runs):
    """PointPillars at the JAX dry run's config, float32, 8 frames: the
    port's step on 2 x 4 frames against its one-process step (each loss
    1e-6 relative, gradients 1e-5 relative L2, BN statistics 1e-6
    relative L2, the AdamW step as ``assert_adam_moved_alike`` says) and
    against the JAX pipeline's step on the 8 frames as one program (each
    loss 1e-5 relative, BN statistics 1e-5 relative L2, the AdamW step
    alike); both ranks hold the same state."""
    res, one, ref = (runs["ranks"]["pp"], runs["one"]["pp"],
                     runs["jax_pp"]["one"])
    assert_ranks_equal(res)
    got = res[0]
    for key, value in one["losses"].items():
        assert rel(got["losses"][key], value) <= 1e-6, key
        assert rel(got["losses"][key], ref["losses"][key]) <= 1e-5, key
    assert rel(sum(got["losses"].values()), ref["loss"]) <= 1e-5
    names = list(one["grads"])
    assert rel_l2(_flat(got["grads"][k] for k in names),
                  _flat(one["grads"][k] for k in names)) <= 1e-5
    stats = _pp_stats(one["state"])
    assert stats
    for key in stats:
        assert rel_l2(got["state"][key], one["state"][key]) <= 1e-6, key
        assert rel_l2(got["state"][key], ref["state"][key]) <= 1e-5, key
    assert_adam_moved_alike(got["state"], one["state"], one["grads"],
                            PP_LR)
    assert_adam_moved_alike(got["state"], ref["state"], got["grads"],
                            PP_LR)


def test_pointpillars_two_ranks_vs_jax_sharded_and_its_pfn_fault(runs):
    """The JAX pipeline's PointPillars step sharded over the 8 devices
    agrees with the port's 2 x 4 step (and with its own one-device step)
    in the loss (1e-5 relative), the BN statistics (1e-5 relative L2)
    and every AdamW-updated parameter outside the pillar feature net
    (``assert_adam_moved_alike``). The pillar feature net's parameters it
    moves otherwise: sharded, the JAX step's gradients of the PFN's
    linear kernel and BatchNorm are 20-30% (relative L2) from its
    one-device step's (measured 0.22, 0.20, 0.29; every other gradient
    within 6e-6), a fault of the JAX package's sharded step
    (``SHARDED_PFN_FAULT`` in ROADMAP.md queue 3) that flips the update of
    some PFN weights whose gradient exceeds 1% of the largest. The port
    holds to the one-program step (the test above)."""
    got, ref, one = (runs["ranks"]["pp"][0], runs["jax_pp"]["sharded"],
                     runs["jax_pp"]["one"])
    assert rel(sum(got["losses"].values()), ref["loss"]) <= 1e-5
    for key in _pp_stats(one["state"]):
        assert rel_l2(got["state"][key], ref["state"][key]) <= 1e-5, key
    pfn = [k for k in got["grads"] if k.startswith("voxel_encoder.")]
    assert pfn
    outside = {k: g for k, g in got["grads"].items() if k not in pfn}
    assert_adam_moved_alike(got["state"], ref["state"], outside, PP_LR)
    # the fault: the sharded step moves PFN weights against the sign of
    # their one-program gradient, the port's and the one-device step's
    # updates agree there
    flipped = 0
    for key in pfn:
        g = got["grads"][key].numpy()
        big = np.abs(g) > 1e-2 * np.abs(g).max()
        sharded = np.abs(got["state"][key].numpy() -
                         ref["state"][key].numpy())
        oned = np.abs(got["state"][key].numpy() - one["state"][key].numpy())
        flipped += int((sharded[big] > PP_LR).sum())
        assert (oned[big] <= 1e-6).all(), key
    assert flipped > 0


def _pp_layout():
    from open3d_ml_tpu_torch.utils.convert_jax import net_layout
    return net_layout(PointPillars(compute_dtype="float32",
                                   **dryrun.POINTPILLARS_DRYRUN).get_net())


@pytest.mark.slow
def test_randla_full_width_two_ranks_equal_one_process(tmp_path):
    """The shipped RandLA-Net (``randlanet_semantickitti.yml``'s model:
    45,056 points, 4 levels, widths 16-256) on a batch of 4 split 2 + 2,
    with the net's own dropout and seeded weights, in float64: the loss,
    every summed gradient (1e-6 relative L2, 1e-12 absolute where it is
    0 in exact arithmetic), the BatchNorm statistics (1e-6) and the Adam
    step (``assert_adam_moved_alike`` wherever |g| > 1e-6) equal the
    one-process step's; the confusion matrix exactly. Minutes on the
    CPU."""
    cfg = {"compute_dtype": "float32"}
    rng = np.random.default_rng(23)
    n = RandLANet().cfg.num_points
    batch = {"coords": lattice_cloud(rng, 4, n),
             "features": rng.uniform(-1, 1, (4, n, 3)).astype(np.float32),
             "labels": rng.integers(0, 19, (4, n)).astype(np.int32)}
    from open3d_ml_tpu_torch.pipelines import SemanticSegmentation
    state = SemanticSegmentation(RandLANet(seed=0, **cfg), device="cpu",
                                 seed=0).net.state_dict()
    inputs = {"randla_cfg": cfg, "randla_state": state,
              "randla_batch": batch}
    torch.save(inputs, tmp_path / "inputs.pt")
    got = spawn(tmp_path, ["randla_own64"], timeout=1800)["randla_own64"]
    assert_ranks_equal(got)
    one = worker.randla_step(inputs, batch, None, torch.float64)
    got = got[0]
    assert rel(got["loss"], one["loss"]) <= 1e-6
    assert torch.equal(got["cm"], one["cm"])
    for name, want in one["grads"].items():
        diff = np.linalg.norm(got["grads"][name] - want)
        assert diff <= 1e-6 * np.linalg.norm(want) + 1e-12, name
    for key, want in one["state"].items():
        if key.endswith(("running_mean", "running_var")):
            assert rel_l2(got["state"][key], want) <= 1e-6, key
    assert_adam_moved_alike(got["state"], one["state"], one["grads"], LR,
                            share=0.0)
