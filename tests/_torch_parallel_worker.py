"""One rank of ``tests/test_torch_parallel.py``: joins a ``gloo`` group on
the CPU through ``parallel.mesh.init_distributed`` (the test sets
torchrun's environment), runs the named cases and writes each case's
result to ``<dir>/<case>_<rank>.pt``.

    python tests/_torch_parallel_worker.py <dir> <case> [<case> ...]

The inputs of the training steps (weights, batches, the JAX dropout mask)
are in ``<dir>/inputs.pt``, written by the test; the others are made here
from seeds (``bn_inputs``, ``mesh_batch``), so the test builds the same.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from open3d_ml_tpu_torch.models import (PointPillars, RandLANet,  # noqa: E402
                                        SparseConvUnet)
from open3d_ml_tpu_torch.models.common import BatchNorm, Dropout  # noqa
from open3d_ml_tpu_torch.modules.losses import SemSegLoss  # noqa: E402
from open3d_ml_tpu_torch.parallel import dryrun, mesh  # noqa: E402
from open3d_ml_tpu_torch.pipelines import (ObjectDetection,  # noqa: E402
                                           SemanticSegmentation)
from open3d_ml_tpu_torch.utils import Config  # noqa: E402

# RandLA-Net's small training step: the widths of test_torch_randlanet's
# SMALL at 1,024 points, float32
RANDLA_SMALL = dict(num_points=1024, num_layers=4, dim_output=[8, 16, 32, 32],
                    seg=32, block=64, num_segs=8, gather_segs=4,
                    infer_num_segs=6, infer_gather_segs=4,
                    compute_dtype="float32")
RANDLA_PIPELINE = dict(optimizer={"lr": 1e-2}, scheduler_gamma=0.9,
                       steps_per_epoch=2)
CLASS_COUNTS = [5000, 320, 541, 2578, 3274, 552, 184, 78, 24094, 1729, 17059,
                636, 23041, 10113, 47649, 983, 12960, 450, 116]
BN_ROWS, BN_C = 8, 5  # the synced BatchNorm's global batch and channels


def class_weights():
    """A stand-in dataset that carries only the class counts."""
    import types
    return types.SimpleNamespace(cfg=Config({"class_weights": CLASS_COUNTS}),
                                 name="counts")


class FixedDropout(torch.nn.Module):
    """Dropout with a given keep mask (rate 0.5)."""

    def __init__(self, keep):
        super().__init__()
        self.keep = keep

    def forward(self, x):
        if not self.training:
            return x
        return torch.where(self.keep, x * 2.0, torch.zeros_like(x))


def bn_inputs():
    """float64 inputs and cotangents of the synced BatchNorm cases: rows
    [8, 6, 5] (channels last), [8, 3, 4, 4] (NCHW), and pillar rows
    [8 * 6, 5] whose batch adds one zero row, shared by the ranks."""
    rng = np.random.default_rng(5)

    def pair(*shape):
        return (torch.from_numpy(rng.normal(0.5, 2.0, shape)),
                torch.from_numpy(rng.normal(0.0, 1.0, shape)))

    return {"last": pair(BN_ROWS, 6, BN_C), "nchw": pair(BN_ROWS, BN_C, 4, 4),
            "pillars": pair(BN_ROWS * 6, BN_C),
            "pad_cot": torch.from_numpy(rng.normal(0.0, 1.0, (2, BN_C)))}


def bn_module(axis):
    torch.manual_seed(0)
    bn = BatchNorm(BN_C, eps=1e-3, axis=axis).double().train()
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    return bn


def bn_step(kind, x, cot, pad_cot=None):
    """(output, input gradient, weight and bias gradients, running mean
    and variance) of one train-mode BatchNorm on ``x``; with ``pad_cot``
    the zero pad row is appended with that cotangent."""
    bn = bn_module(1 if kind == "nchw" else -1)
    x = x.clone().requires_grad_(True)
    rows = x
    if pad_cot is not None:
        rows = torch.cat([x, x.new_zeros((1, BN_C))])
        cot = torch.cat([cot, pad_cot[None]])
    out = bn(rows, shared_rows=1) if pad_cot is not None else bn(rows)
    (out * cot).sum().backward()
    return {"out": out.detach(), "dx": x.grad, "dw": bn.weight.grad,
            "db": bn.bias.grad, "mean": bn.running_mean,
            "var": bn.running_var}


def mesh_batch(n):
    """A collated batch of ``n`` rows: an array, pyramid levels, a list of
    per-sample values and a scalar."""
    return {"coords": np.arange(n * 6, dtype=np.float32).reshape(n, 3, 2),
            "levels": [np.arange(n * 4).reshape(n, 4),
                       np.arange(n * 2).reshape(n, 2)],
            "names": [f"s{i}" for i in range(n)], "calib": None}


def case_mesh(m, d):
    out = {"mesh": tuple(m), "made": tuple(mesh.make_mesh()),
           "shard8": mesh.shard_batch(mesh_batch(8), m),
           "shard3": mesh.shard_batch(mesh_batch(3), m),
           "gather": mesh.process_allgather({"rank": m.rank})}
    state = {"w": torch.full((2, 3), float(m.rank + 1)),
             "n": torch.tensor([m.rank + 5])}
    out["replicated"] = {k: v.clone() for k, v in
                         mesh.replicate(state, m).items()}
    # the differentiable sum: d(sum_r c_r * S) / dx_r = sum_r c_r
    x = torch.full((3,), float(m.rank + 1), requires_grad=True)
    s = mesh.all_reduce_sum(x)
    (s * float(m.rank + 2)).sum().backward()
    out["sum"], out["sum_grad"] = s.detach(), x.grad
    one = torch.tensor(float(m.rank + 1))
    out["global_outside"] = mesh.global_sum(one)
    with mesh.split(m, 8) as is_split:
        out["global_inside"], out["is_split"] = mesh.global_sum(one), is_split
    with mesh.split(m, 3) as is_split:
        out["odd_split"] = is_split
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.arange(4.0) * (m.rank + 1)
    mesh.reduce_gradients([p])
    out["grad"] = p.grad
    drop = Dropout(0.5, seed=3).train()
    with mesh.split(m, 8):
        out["dropout"] = drop(torch.ones(4, 5, 3))
    return out


def case_bn(m, d):
    data, out = bn_inputs(), {}
    for kind in ("last", "nchw", "pillars"):
        x, cot = data[kind]
        rows = slice(*mesh.batch_rows(x.shape[0], m))
        with mesh.split(m, x.shape[0]):
            res = bn_step(kind, x[rows], cot[rows],
                          data["pad_cot"][m.rank] if kind == "pillars"
                          else None)
        p = [torch.nn.Parameter(torch.zeros(BN_C, dtype=torch.float64))
             for _ in range(2)]
        p[0].grad, p[1].grad = res["dw"].clone(), res["db"].clone()
        mesh.reduce_gradients(p)
        res["dw"], res["db"] = p[0].grad, p[1].grad
        out[kind] = res
    return out


def randla_step(inputs, batch, keep, dtype=torch.float32):
    """One step of the RandLA pipeline (the inputs' ``randla_cfg``, by
    default ``RANDLA_SMALL``) from the inputs' weights on ``batch`` (the
    global batch; this rank's share of it), with ``keep``
    as the dropout mask of this rank's rows (None: the net's own). In
    float64, the net and the features are float64 (the fused path's
    coordinates stay float32)."""
    model = RandLANet(seed=0, **inputs.get("randla_cfg", RANDLA_SMALL))
    pipe = SemanticSegmentation(model, device="cpu", seed=0,
                                **RANDLA_PIPELINE)
    pipe.net.load_state_dict(inputs["randla_state"])
    pipe.net.to(dtype)
    batch = dict(batch, features=batch["features"].astype(
        torch.empty((), dtype=dtype).numpy().dtype))
    if keep is not None:
        pipe.net.dropout = FixedDropout(keep)
    pipe.optimizer, pipe.scheduler = model.get_optimizer(pipe.cfg, pipe.net)
    loss, cm = pipe._on_rows(pipe._train_step, {"data": batch},
                             SemSegLoss(pipe, model, class_weights()))
    return {"loss": loss, "cm": cm,
            "grads": {k: p.grad for k, p in pipe.net.named_parameters()},
            "state": pipe.net.state_dict()}


def case_randla(m, d, dtype=torch.float32):
    inputs = torch.load(Path(d) / "inputs.pt", weights_only=False)
    batch = inputs["randla_batch"]
    rows = slice(*mesh.batch_rows(len(batch["coords"]), m))
    return randla_step(inputs, batch, inputs["randla_keep"][rows], dtype)


def case_randla64(m, d):
    return case_randla(m, d, torch.float64)


def case_randla_own64(m, d):
    """Float64, with the net's own dropout (each rank keeps its rows of
    the global batch's mask)."""
    inputs = torch.load(Path(d) / "inputs.pt", weights_only=False)
    return randla_step(inputs, inputs["randla_batch"], None, torch.float64)


def case_randla_odd(m, d):
    """3 rows on 2 ranks: every rank runs all of them, with the net's own
    dropout."""
    inputs = torch.load(Path(d) / "inputs.pt", weights_only=False)
    batch = {k: v[:3] for k, v in inputs["randla_batch"].items()}
    return randla_step(inputs, batch, None)


def pp_step(inputs, batch):
    model = PointPillars(compute_dtype="float32", seed=0,
                         **inputs.get("pp_cfg", dryrun.POINTPILLARS_DRYRUN))
    pipe = ObjectDetection(model, device="cpu", seed=0)
    pipe.net.load_state_dict(inputs["pp_state"])
    pipe.optimizer, _ = model.get_optimizer(pipe.cfg, pipe.net)
    losses = pipe._on_rows(pipe._train_step, {"data": batch})
    return {"losses": losses,
            "grads": {k: p.grad for k, p in pipe.net.named_parameters()},
            "state": pipe.net.state_dict()}


def case_pp(m, d):
    inputs = torch.load(Path(d) / "inputs.pt", weights_only=False)
    return pp_step(inputs, inputs["pp_batch"])


def case_dryrun(m, d):
    return {"train": dryrun.dryrun_train_step(device="cpu"),
            "objdet": dryrun.dryrun_objdet_step(device="cpu")}


def case_refuse(m, d):
    """SparseConvUnet's pipeline on more than one rank raises."""
    try:
        SemanticSegmentation(SparseConvUnet(), device="cpu")
    except NotImplementedError as err:
        return {"error": str(err)}
    return {"error": None}


def main():
    torch.set_num_threads(1)
    d, cases = sys.argv[1], sys.argv[2:]
    m = mesh.init_distributed("gloo", "cpu")
    try:
        for case in cases:
            out = globals()[f"case_{case}"](m, d)
            torch.save(out, Path(d) / f"{case}_{m.rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
