"""Object detection pipeline: training, validation (mAP), test and
inference.

Counterpart of ``open3d_ml_tpu/pipelines/object_detection.py``:

* ``run_train``: epochs of training steps over the train split (its
  ``preprocess`` augments), ``batch_size`` frames a step with the last
  short batch dropped, each step the model's net (``get_net``) in train
  mode, ``get_loss`` (PointPillars' anchor assignment, PointRCNN's
  per-point labels or roi targets, on the device), the backward and one
  AdamW step (``get_optimizer``: PointRCNN's moves one stage; no
  gradient clipping, as the JAX pipeline has none); the epoch's mean
  losses to the log and, as ``train/<loss>``, to a TensorBoard writer
  (``BasePipeline._make_writer``: ``<train_sum_dir>/<run id>_<model>_
  <dataset>_torch``, with the command line and the configuration as
  text); ``run_valid`` every ``validation_freq`` epochs, its mAP also to
  the writer as ``valid/mAP_BEV`` and ``valid/mAP_3D``;
  checkpoints every ``save_ckpt_freq`` epochs and at the last. A resume
  restores the weights and the BatchNorm statistics of the newest
  checkpoint and starts AdamW afresh, as the JAX pipeline does (it saves
  ``opt_state`` but never restores it);
* ``run_valid``: every frame of the validation split through the eval
  net and the decode, then the KITTI mAP (BEV and 3D) of the boxes
  against the frames' gt boxes;
* ``run_test``: the test split with the newest checkpoint's weights (or
  ``ckpt_path``'s), its boxes written by ``dataset.save_test_result``;
* ``run_inference``: one in-memory frame.

All three ride the model's eval net (``get_eval_net``: PointPillars'
compact pillars with the reference's caps, float32), which takes a copy
of ``net``'s ``state_dict`` (the serving net, ``get_net``) before each
run. Both live on ``device``. The weights start from a generator seeded
by the pipeline's ``seed``, and so do a net's own generators where it has
them (``manual_seed``: PointRCNN's dropout and roi sampling, each step's
draws made on ``device``; the JAX pipeline draws a key a step). Load
trained weights with ``net.load_state_dict`` (for JAX variables,
``utils.convert_jax.load_jax_variables``) or from a checkpoint:
``torch.save`` files ``<logs_dir>/checkpoint/ckpt_{epoch:05d}.pth`` of
{"model", "optimizer", "epoch"}. PointRCNN's stage 2 cannot start from a
stage-1 checkpoint (``models/point_rcnn.py`` ``HANDOFF_FAULT``, as in
JAX): give it the RPN's weights with ``net.load_state_dict(state,
strict=False)`` and a log directory of its own.

Not ported: reading the JAX package's orbax checkpoints.

In a process group of more than one rank (``parallel.mesh``), every rank
draws the same global training batches (the augmentation's generators
alike) and runs its share of each: the BatchNorm statistics and the
losses' divisor are the global batch's, one all-reduce sums the
gradients, and the losses are summed over the ranks; the net's state is
broadcast from rank 0 before the first epoch. ``run_valid`` splits the
validation frames over the ranks and gathers their boxes
(``process_allgather``) in frame order before the mAP. ``run_test`` and
``run_inference`` run on rank 0 alone.
"""

import logging
from os.path import exists
from pathlib import Path

import numpy as np
import torch

from ..dataloaders import BatchLoader, DefaultBatcher, PointCloudDataloader
from ..datasets.utils import BEVBox3D
from ..metrics import mAP
from ..parallel.mesh import (barrier, current_split, global_sum,
                             process_allgather, reduce_gradients, replicate)
from ..utils import make_dir
from ..utils.registry import PIPELINE
from .base_pipeline import BasePipeline
from .semantic_segmentation import init_weights

log = logging.getLogger(__name__)


@PIPELINE.register_module()
class ObjectDetection(BasePipeline):
    """Training, validation, test and inference of 3D object detection.
    The defaults of ``batch_size``, ``max_epoch`` and ``save_ckpt_freq``
    are the shipped KITTI config's."""

    def __init__(self, model, dataset=None, name="ObjectDetection",
                 batch_size=6, val_batch_size=1, test_batch_size=1,
                 max_epoch=200, save_ckpt_freq=5, main_log_dir="./logs/",
                 device="cuda", num_workers=2, **kwargs):
        super().__init__(model=model, dataset=dataset, name=name,
                         batch_size=batch_size, max_epoch=max_epoch,
                         save_ckpt_freq=save_ckpt_freq,
                         val_batch_size=val_batch_size,
                         test_batch_size=test_batch_size,
                         main_log_dir=main_log_dir, device=device,
                         num_workers=num_workers, **kwargs)
        top = np.iinfo(np.int32).max
        gen = torch.Generator().manual_seed(int(self.rng.integers(top)))
        self.net = init_weights(model.get_net(), gen).to(self.device).eval()
        if hasattr(self.net, "manual_seed"):
            self.net.manual_seed(int(self.rng.integers(top)))
        self.eval_net = model.get_eval_net().to(self.device).eval()
        self.optimizer = None

    def _device_batch(self, batch):
        """The batch's arrays as tensors on the pipeline's device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch["data"].items()
                if isinstance(v, np.ndarray)}

    def _loader(self, split, batch_size, steps_per_epoch=None,
                drop_last=False, num_workers=None, over_ranks=False):
        """Batches of ``split``; with ``over_ranks``, of this rank's frames
        only: rank, rank + ranks, ..."""
        model, dataset = self.model, self.dataset
        dataloader = PointCloudDataloader(
            dataset.get_split(split), preprocess=model.preprocess,
            transform=model.transform,
            use_cache=dataset.cfg.get("use_cache", False),
            steps_per_epoch=steps_per_epoch)
        if over_ranks:
            dataloader = _Frames(dataloader, range(
                self.mesh.rank, len(dataloader), self.mesh.size))
        return BatchLoader(dataloader, batch_size, DefaultBatcher(),
                           num_workers=self.cfg.get("num_workers", 2)
                           if num_workers is None else num_workers,
                           drop_last=drop_last)

    def _detect(self, batch):
        """The eval net and the decode on one collated batch: one list of
        ``BEVBox3D`` per sample."""
        with torch.no_grad():
            results = self.eval_net(self._device_batch(batch))
        return self.model.inference_end(results, batch["data"])

    def _train_step(self, inputs):
        """One AdamW step of the net in train mode on a device batch (this
        rank's share of a split batch); returns the loss dict, the global
        batch's, detached, on the device."""
        net = self.net
        net.train()
        losses = self.model.get_loss(net(inputs), inputs)
        self.optimizer.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        if current_split() is not None:
            reduce_gradients(net.parameters())
        self.optimizer.step()
        return {k: global_sum(v.detach()) for k, v in losses.items()}

    def run_train(self):
        """Train from the newest checkpoint (or from the start) up to
        ``max_epoch``, epochs 0 to ``max_epoch`` both included. The
        optimizer comes first, so a model whose ``get_optimizer`` raises
        leaves no log directory behind."""
        self.optimizer, _ = self.model.get_optimizer(self.cfg, self.net)
        with self._log_file(log, "train"):
            self._train_epochs()

    def _train_epochs(self):
        model, cfg = self.model, self.cfg
        steps = self.dataset.cfg.get("steps_per_epoch_train")
        # the JAX pipeline draws one batch in this thread to build its
        # state before the epochs, which moves the augmentation's
        # generator; so does this
        next(iter(self._loader("training", cfg.batch_size, steps,
                               num_workers=0)))
        first_epoch = self.load_ckpt(model.cfg.get("ckpt_path"),
                                     is_resume=model.cfg.get("is_resume",
                                                             True))
        replicate(self.net.state_dict(), self.mesh)
        writer = self._make_writer()
        try:
            self._epochs(first_epoch, steps, writer)
        finally:
            writer.close()

    def _epochs(self, first_epoch, steps, writer):
        cfg = self.cfg
        log.info("Started training")
        for epoch in range(first_epoch, cfg.max_epoch + 1):
            log.info(f"=== EPOCH {epoch:d}/{cfg.max_epoch:d} ===")
            self.losses = {}
            for batch in self._loader("training", cfg.batch_size, steps,
                                      drop_last=True):
                losses = self._on_rows(self._train_step, batch)
                values = torch.stack(list(losses.values())).tolist()
                for key, value in zip(losses, values):
                    self.losses.setdefault(key, []).append(value)
            for key, values in self.losses.items():
                writer.add_scalar(f"train/{key}", float(np.mean(values)),
                                  epoch)
                log.info(f"{key}: {np.mean(values):.4f}")
            if epoch % cfg.get("validation_freq", 1) == 0:
                self.run_valid(epoch, writer=writer)
            if epoch % cfg.save_ckpt_freq == 0 or epoch == cfg.max_epoch:
                self.save_ckpt(epoch)

    def run_valid(self, epoch=0, writer=None):
        """The mAP (BEV and 3D) of the validation split at the config's
        ``overlaps``, ``difficulties`` and ``similar_classes``, also to
        ``writer`` where given; returns (ap_bev, ap_3d), each
        [num_classes, num_difficulties, 1], or None for an empty split.
        Over ranks, each detects the frames rank, rank + ranks, ... and
        every rank takes the mAP of all of them, in frame order."""
        model, cfg, ranks = self.model, self.cfg, self.mesh.size
        self.eval_net.load_state_dict(self.net.state_dict())
        frames = []
        for batch in self._loader("validation", cfg.val_batch_size,
                                  over_ranks=ranks > 1):
            for i, boxes in enumerate(self._detect(batch)):
                frames.append((BEVBox3D.to_dicts(boxes), BEVBox3D.to_dicts(
                    batch["data"]["bbox_objs"][i])))
        if ranks > 1:
            # the reference's dist.gather_object; rank r's k-th frame is
            # frame r + k * ranks
            parts = process_allgather(frames)
            frames = [part[k] for k in range(len(parts[0]))
                      for part in parts if k < len(part)]
        pred = [p for p, _ in frames]
        gt = [g for _, g in frames]
        if not pred:
            return None

        sim_classes = cfg.get("similar_classes", {})
        difficulties = cfg.get("difficulties", [0])
        overlaps = cfg.get("overlaps", [0.5])
        ap_bev = mAP(pred, gt, model.classes, difficulties, overlaps,
                     bev=True, similar_classes=sim_classes)
        ap_3d = mAP(pred, gt, model.classes, difficulties, overlaps,
                    bev=False, similar_classes=sim_classes)
        for title, ap in (("BEV", ap_bev), ("3D", ap_3d)):
            log.info(f"=== mAP {title} (epoch {epoch}) ===")
            for i, c in enumerate(model.classes):
                log.info(f"{c}: {ap[i].mean():.2f}")
            log.info(f"Overall: {ap.mean():.2f}")
        if writer is not None:
            writer.add_scalar("valid/mAP_BEV", float(ap_bev.mean()), epoch)
            writer.add_scalar("valid/mAP_3D", float(ap_3d.mean()), epoch)
        self.valid_map_bev = float(ap_bev.mean())
        self.valid_map_3d = float(ap_3d.mean())
        return ap_bev, ap_3d

    def run_test(self):
        """Detect in every frame of the test split with the newest
        checkpoint's weights (or ``ckpt_path``'s) and save the boxes
        through the dataset; returns one list of boxes per frame. On rank
        0 alone."""
        return self._on_rank0(self._run_test)

    def _run_test(self):
        self.load_ckpt(self.model.cfg.get("ckpt_path"))
        self.eval_net.load_state_dict(self.net.state_dict())
        results, attrs = [], []
        for batch in self._loader("test", self.cfg.test_batch_size):
            results.extend(self._detect(batch))
            # un-collate the attr dict of lists
            attr = batch["attr"]
            n = len(next(iter(attr.values())))
            attrs.extend({k: v[i] for k, v in attr.items()}
                         for i in range(n))
        self.dataset.save_test_result(results, attrs)
        return results

    def run_inference(self, data):
        """Detect objects in one in-memory frame {'point' [N, >= 4],
        'calib' or None}; returns its list of ``BEVBox3D``. On rank 0
        alone."""
        return self._on_rank0(self._run_inference, data)

    def _run_inference(self, data):
        model = self.model
        attr = {"split": "test"}
        sample = model.transform(model.preprocess(data, attr), attr)
        batch = DefaultBatcher().collate_fn([{"data": sample, "attr": attr}])
        self.eval_net.load_state_dict(self.net.state_dict())
        return self._detect(batch)[0]

    # ------------------------------------------------------------ checkpoint

    def _ckpt_dir(self):
        return Path(self.cfg.logs_dir) / "checkpoint"

    def save_ckpt(self, epoch):
        """Write the net's weights and BatchNorm statistics, and the
        optimizer's state where there is one, as those of ``epoch`` (rank
        0; every rank waits for it)."""
        path = self._ckpt_dir() / f"ckpt_{epoch:05d}.pth"
        if self.writes:
            make_dir(path.parent)
            optimizer = (None if self.optimizer is None else
                         self.optimizer.state_dict())
            torch.save({"model": self.net.state_dict(),
                        "optimizer": optimizer, "epoch": epoch}, path)
            log.info(f"Epoch {epoch:3d}: save ckpt to {path}")
        barrier(self.mesh)
        return path

    def load_ckpt(self, ckpt_path=None, is_resume=True):
        """Load ``ckpt_path``, or with ``is_resume`` the newest checkpoint
        of ``logs_dir``, into the net, its BatchNorm statistics included;
        the optimizer's state stays as it is, as the JAX pipeline leaves
        it. Returns the epoch after the checkpoint's: 0 when there is
        none."""
        if ckpt_path is None and is_resume:
            found = sorted(self._ckpt_dir().glob("ckpt_*.pth"))
            if found:
                ckpt_path = found[-1]
        if ckpt_path is None or not exists(ckpt_path):
            log.info("Initializing from scratch.")
            return 0
        ckpt = torch.load(ckpt_path, map_location=self.device,
                          weights_only=True)
        self.net.load_state_dict(ckpt["model"])
        log.info(f"Loading checkpoint {ckpt_path}")
        return int(ckpt["epoch"]) + 1


class _Frames:
    """Frames ``indices`` of a dataloader, in that order."""

    def __init__(self, dataloader, indices):
        self.dataloader = dataloader
        self.indices = indices

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataloader[self.indices[i]]
