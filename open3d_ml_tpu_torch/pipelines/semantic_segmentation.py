"""Semantic segmentation pipeline: training, validation, test and inference.

Counterpart of ``open3d_ml_tpu/pipelines/semantic_segmentation.py``:

* ``run_train``: epochs of training steps over the train split (the
  model's net, ``get_net``: on the fused path, at the training table
  budget), each step the forward, the loss plus the model's
  ``regularizer_loss`` (KPConv's deformable convolutions'), the
  backward, the optional clip by value, the optimizer's step (the
  model's ``get_optimizer``), the scheduler step and the step's
  confusion matrix counted on the device; then validation through the
  same net in eval mode (the inference budget); each epoch's six scalars
  (the JAX package's tags: loss, accuracy and IoU, training and
  validation) to the log and to a TensorBoard writer in
  ``<train_sum_dir>/<run id>_<model>_<dataset>_torch``, which also holds
  the command line and the configuration as text and, where the
  ``summary`` config's ``record_for`` names "train", the first batch's
  clouds coloured by the net's labels each epoch (``summaries.py``);
  checkpoints every ``save_ckpt_freq`` epochs and at the last, and resume
  from the newest one.
* ``run_test`` and ``run_inference``: the possibility-map patch loop,
  which draws patches until every point of a cloud is covered, blends each
  patch's class probabilities into the cloud's accumulator and projects
  them onto the input points, through the eval net (``get_eval_net``:
  exact neighbours).

The two nets share one ``state_dict``: ``net`` holds it (and the
optimizer updates it), and the eval net takes a copy before each test or
inference. Both live on ``device``. The weights start from a generator
seeded by the pipeline's ``seed``, and so does the dropout's generator
where the net has a dropout; load trained weights with
``net.load_state_dict`` (for JAX variables,
``utils.convert_jax.jax_to_state_dict``) or from a checkpoint.

Checkpoints are ``torch.save`` files ``<logs_dir>/checkpoint/
ckpt_{epoch:05d}.pth`` of {"model", "optimizer", "scheduler", "epoch"}.
Not ported: reading the JAX package's orbax checkpoints.
"""

import logging
from datetime import datetime
from os.path import exists, join
from pathlib import Path

import numpy as np
import torch

from ..dataloaders import BatchLoader, DefaultBatcher, PointCloudDataloader
from ..datasets import InferenceDummySplit
from ..models.common import MaskedBatchNorm
from ..modules.losses import SemSegLoss
from ..modules.metrics import SemSegMetric, confusion_matrix_device
from ..utils import make_dir
from ..utils.registry import PIPELINE
from .base_pipeline import BasePipeline
from .summaries import record_summary

log = logging.getLogger(__name__)


def init_weights(net, gen):
    """Draw ``net``'s weights from ``gen``, module by module in registration
    order: a Linear's or a convolution's weight and bias (where it has
    one) uniform in +-1/sqrt(fan_in), as torch's defaults draw them;
    BatchNorm at the identity; any other module with a
    ``reset_parameters(gen)`` (the SparseConvUnet net and its convolutions,
    for their stencil weights) draws its own."""
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, (torch.nn.Linear,
                                   torch.nn.modules.conv._ConvNd)):
                fan_in = torch.nn.init._calculate_fan_in_and_fan_out(
                    module.weight)[0]
                bound = fan_in ** -0.5
                module.weight.uniform_(-bound, bound, generator=gen)
                if module.bias is not None:
                    module.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(module, (torch.nn.modules.batchnorm._BatchNorm,
                                     MaskedBatchNorm)):
                module.reset_parameters()
            elif hasattr(module, "reset_parameters"):
                module.reset_parameters(gen)
    return net


def _levels(v):
    """Whether ``v`` is a collated list of arrays (a pyramid's levels)."""
    return isinstance(v, list) and bool(v) and isinstance(v[0], np.ndarray)


def _sample(data, j):
    """Sample ``j`` of a collated batch, as a batch of one: arrays sliced,
    and lists of arrays level by level."""
    return {k: [x[j:j + 1] for x in v] if _levels(v) else v[j:j + 1]
            for k, v in data.items()}


@PIPELINE.register_module()
class SemanticSegmentation(BasePipeline):
    """Training, validation, test and inference for point cloud semantic
    segmentation."""

    def __init__(self, model, dataset=None, name="SemanticSegmentation",
                 batch_size=4, val_batch_size=4, test_batch_size=1,
                 max_epoch=100, save_ckpt_freq=20, adam_lr=1e-2,
                 scheduler_gamma=0.95, main_log_dir="./logs/", device="cuda",
                 num_workers=2, **kwargs):
        super().__init__(model=model, dataset=dataset, name=name,
                         batch_size=batch_size, val_batch_size=val_batch_size,
                         test_batch_size=test_batch_size, max_epoch=max_epoch,
                         save_ckpt_freq=save_ckpt_freq, adam_lr=adam_lr,
                         scheduler_gamma=scheduler_gamma,
                         main_log_dir=main_log_dir, device=device,
                         num_workers=num_workers, **kwargs)
        top = np.iinfo(np.int32).max
        gen = torch.Generator().manual_seed(int(self.rng.integers(top)))
        self.net = init_weights(model.get_net(), gen).to(self.device)
        if hasattr(self.net, "dropout"):
            self.net.dropout.manual_seed(int(self.rng.integers(top)))
        self.eval_net = model.get_eval_net().to(self.device).eval()
        self.optimizer = self.scheduler = None

    def _device_batch(self, batch):
        """The batch's arrays, and its lists of arrays (a host-built
        pyramid's levels), as tensors on the pipeline's device."""
        def move(v):
            return torch.from_numpy(v).to(self.device)

        out = {}
        for k, v in batch["data"].items():
            if isinstance(v, np.ndarray):
                out[k] = move(v)
            elif _levels(v):
                out[k] = [move(x) for x in v]
        return out

    # ----------------------------------------------------------------- steps

    def _train_step(self, inputs, loss_fn):
        """One optimizer step on a device batch; returns (loss, the step's
        confusion matrix), both on the device."""
        model, net = self.model, self.net
        net.train()
        results = net(inputs)
        loss, labels, scores = model.get_loss(loss_fn, results, inputs)
        loss = loss + model.regularizer_loss(net)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip = model.cfg.get("grad_clip_norm", -1)
        if clip and clip > 0:
            # by value, as the JAX package and its reference clip
            for p in net.parameters():
                if p.grad is not None:
                    p.grad.clamp_(-clip, clip)
        self.optimizer.step()
        self.scheduler.step()
        scores = scores.detach()
        cm = confusion_matrix_device(scores, labels,
                                     torch.ones_like(labels, dtype=torch.bool),
                                     model.cfg.num_classes)
        return loss.detach(), cm

    def _eval_step(self, inputs, loss_fn):
        """The training net in eval mode on a device batch; returns (loss,
        confusion matrix)."""
        model, net = self.model, self.net
        net.eval()
        with torch.no_grad():
            results = net(inputs)
            loss, labels, scores = model.get_loss(loss_fn, results, inputs)
            cm = confusion_matrix_device(
                scores, labels, torch.ones_like(labels, dtype=torch.bool),
                model.cfg.num_classes)
        return loss, cm

    # ----------------------------------------------------------------- train

    def _split_loader(self, split, steps_key=None):
        model, dataset = self.model, self.dataset
        dataset_split = dataset.get_split(split)
        return PointCloudDataloader(
            dataset_split, preprocess=model.preprocess,
            transform=model.transform, sampler=dataset_split.sampler,
            use_cache=dataset.cfg.get("use_cache", False),
            steps_per_epoch=(dataset.cfg.get(steps_key) if steps_key
                             else None))

    def run_train(self):
        """Train from the newest checkpoint (or from the start) up to
        ``max_epoch``, validating after every epoch."""
        cfg = self.cfg
        make_dir(cfg.logs_dir)
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        handler = logging.FileHandler(join(cfg.logs_dir,
                                           f"log_train_{stamp}.txt"))
        log.addHandler(handler)
        try:
            return self._train_epochs()
        finally:
            log.removeHandler(handler)
            handler.close()

    def _train_epochs(self):
        model, cfg = self.model, self.cfg
        loss_fn = SemSegLoss(self, model, self.dataset)
        self.metric_train = SemSegMetric()
        self.metric_val = SemSegMetric()
        train_split = self._split_loader("train", "steps_per_epoch_train")
        valid_split = self._split_loader("validation",
                                         "steps_per_epoch_valid")
        for split in (train_split, valid_split):
            # an epoch draws len(split) patches, cycling over the clouds
            # (the JAX package's sampler stops after one pass over them)
            split.sampler.initialize_with_dataloader(split)
        # the schedule decays once per epoch of optimizer steps
        cfg["steps_per_epoch"] = max(len(train_split) // cfg.batch_size, 1)
        self.optimizer, self.scheduler = model.get_optimizer(cfg, self.net)
        first_epoch = self.load_ckpt(model.cfg.get("ckpt_path"),
                                     is_resume=model.cfg.get("is_resume",
                                                             True))
        writer = self._make_writer()
        try:
            self._epochs(first_epoch, train_split, valid_split, loss_fn,
                         writer)
        finally:
            writer.close()

    def _epochs(self, first_epoch, train_split, valid_split, loss_fn,
                writer):
        model, cfg = self.model, self.cfg
        batcher = DefaultBatcher()
        record_for = (cfg.get("summary") or {}).get("record_for") or []
        log.info("Started training")
        for epoch in range(first_epoch, cfg.max_epoch + 1):
            log.info(f"=== EPOCH {epoch:d}/{cfg.max_epoch:d} ===")
            self.metric_train.reset()
            self.metric_val.reset()
            self.losses, self.valid_losses = [], []
            for split, bs, step, metric, losses, record in (
                    (train_split, cfg.batch_size, self._train_step,
                     self.metric_train, self.losses, "train" in record_for),
                    (valid_split, cfg.val_batch_size, self._eval_step,
                     self.metric_val, self.valid_losses, False)):
                model.trans_point_sampler = split.sampler.get_point_sampler()
                loader = BatchLoader(split, bs, batcher,
                                     num_workers=cfg.get("num_workers", 2),
                                     sampler=split.sampler, drop_last=True)
                for i, batch in enumerate(loader):
                    inputs = self._device_batch(batch)
                    loss, cm = step(inputs, loss_fn)
                    metric.update_cm(cm)
                    losses.append(float(loss))
                    if i == 0 and record:
                        self._record_train(writer, batch, inputs, epoch)
            self.save_logs(writer, epoch)
            if epoch % cfg.save_ckpt_freq == 0 or epoch == cfg.max_epoch:
                self.save_ckpt(epoch)

    def _record_train(self, writer, batch, inputs, epoch):
        """The summary of the epoch's first training batch: its clouds
        coloured by the updated net's labels in eval mode."""
        self.net.eval()
        with torch.no_grad():
            results = self.net(inputs).cpu().numpy()
        record_summary(writer, self.cfg.get("summary"), "train", "semseg",
                       batch["data"], results, epoch,
                       getattr(self.dataset, "label_to_names", None))

    def save_logs(self, writer, epoch):
        """The epoch's mean losses, and the last accuracy and IoU of its
        confusion matrices, to ``writer`` (NaN as 0) and to the log."""
        train_acc, val_acc = self.metric_train.acc(), self.metric_val.acc()
        train_iou, val_iou = self.metric_train.iou(), self.metric_val.iou()

        def last(values):
            return values[-1] if values else 0.0

        def mean(values):
            return np.mean(values) if values else 0.0

        scalars = {"Training loss": mean(self.losses),
                   "Validation loss": mean(self.valid_losses),
                   "Training accuracy": last(train_acc),
                   "Validation accuracy": last(val_acc),
                   "Training IoU": last(train_iou),
                   "Validation IoU": last(val_iou)}
        for tag, value in scalars.items():
            writer.add_scalar(tag, float(np.nan_to_num(value)), epoch)
        log.info(f"Epoch {epoch}: loss train: {mean(self.losses):.3f} "
                 f"eval: {mean(self.valid_losses):.3f}")
        log.info(f"Epoch {epoch}: mean acc train: {last(train_acc):.3f} "
                 f"eval: {last(val_acc):.3f}")
        log.info(f"Epoch {epoch}: mean IoU train: {last(train_iou):.3f} "
                 f"eval: {last(val_iou):.3f}")

    # ------------------------------------------------------------ checkpoint

    def _ckpt_dir(self):
        return Path(self.cfg.logs_dir) / "checkpoint"

    def save_ckpt(self, epoch):
        """Write the net, optimizer and scheduler state of ``epoch``."""
        path = self._ckpt_dir() / f"ckpt_{epoch:05d}.pth"
        make_dir(path.parent)
        torch.save({"model": self.net.state_dict(),
                    "optimizer": self.optimizer.state_dict(),
                    "scheduler": self.scheduler.state_dict(),
                    "epoch": epoch}, path)
        log.info(f"Epoch {epoch:3d}: save ckpt to {path}")

    def load_ckpt(self, ckpt_path=None, is_resume=True):
        """Load ``ckpt_path``, or with ``is_resume`` the newest checkpoint
        of ``logs_dir``, into the net, and into the optimizer and the
        scheduler where they exist. Returns the epoch to start from: 0
        when there is no checkpoint."""
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
        if self.optimizer is not None:
            self.optimizer.load_state_dict(ckpt["optimizer"])
            self.scheduler.load_state_dict(ckpt["scheduler"])
        log.info(f"Loading checkpoint {ckpt_path}")
        return int(ckpt["epoch"]) + 1

    # ------------------------------------------------------------------ test

    def run_test(self):
        """The patch loop over every cloud of the test split with the
        newest checkpoint's weights (or ``ckpt_path``'s); the predictions
        go to ``dataset.save_test_result``."""
        model = self.model
        self.load_ckpt(model.cfg.get("ckpt_path"))
        test_split = self._split_loader("test")
        return self.run_test_on_split(test_split, test_split.sampler,
                                      save_results=True)

    def run_inference(self, data):
        """Inference on one in-memory cloud {'point' [N, 3], 'feat' [N, d]
        or None, 'label' or None}; returns {'predict_labels' [N],
        'predict_scores' [N, num_classes]}."""
        model = self.model
        infer_split = InferenceDummySplit(data, seed=self.cfg.get("seed"))
        test_split = PointCloudDataloader(infer_split,
                                          preprocess=model.preprocess,
                                          transform=model.transform)
        results = self.run_test_on_split(test_split, infer_split.sampler)
        return results[0]

    def run_test_on_split(self, test_split, test_sampler, save_results=False):
        """Possibility-map patch loop over every cloud of ``test_split``
        through the eval net; returns {cloud id: result}, also kept as
        ``test_results``. Raises ``NotImplementedError`` for a model whose
        ``transform`` does not draw its patches with the sampler (the loop
        would never end)."""
        model = self.model
        if not model.draws_patches:
            raise NotImplementedError(
                f"{type(model).__name__}: test and inference through the "
                "possibility-map loop are not ported: its transform never "
                "advances the possibility map, so the loop would not end "
                f"({model.patch_loop_queue}); run_train runs")
        self.eval_net.load_state_dict(self.net.state_dict())
        batcher = DefaultBatcher()
        test_sampler.initialize_with_dataloader(test_split)
        model.trans_point_sampler = test_sampler.get_point_sampler()

        test_probs = {}
        results_per_cloud = {}
        test_bs = int(self.cfg.get("test_batch_size", 1) or 1)
        cloud_iter = test_sampler.get_cloud_sampler()
        done = False
        while not done:
            # several patches per forward; the sampler updates the
            # possibilities between draws, so patches tile what is left
            samples, cloud_ids = [], []
            for _ in range(test_bs):
                try:
                    cid = next(cloud_iter)
                except StopIteration:
                    done = True
                    break
                samples.append(test_split[cid])
                cloud_ids.append(cid)
            if not samples:
                break
            batch = batcher.collate_fn(samples)
            with torch.no_grad():
                results = self.eval_net(
                    self._device_batch(batch)).cpu().numpy()

            for cid in set(cloud_ids):
                if cid not in test_probs:
                    n = test_sampler.possibilities[cid].shape[0]
                    test_probs[cid] = np.zeros((n, model.cfg.num_classes),
                                               np.float16)
            for j, cid in enumerate(cloud_ids):
                test_probs[cid] = model.update_probs(
                    _sample(batch["data"], j), results[j:j + 1],
                    test_probs[cid])
            for cid in set(cloud_ids) - set(results_per_cloud):
                self._maybe_finalize_cloud(cid, test_split, test_sampler,
                                           test_probs, results_per_cloud,
                                           save_results)
        self.test_results = results_per_cloud
        return results_per_cloud

    def _maybe_finalize_cloud(self, cloud_id, test_split, test_sampler,
                              test_probs, results_per_cloud, save_results):
        """When a cloud is covered, project its probabilities onto the
        input points, store the prediction and, with ``save_results``,
        save it through the dataset."""
        if test_sampler.min_possibilities[cloud_id] <= 0.5:
            return
        split = test_split.dataset
        attr = split.get_attr(cloud_id)
        if test_split.cache_convert is not None:
            data = test_split.cache_convert(attr["name"])
        else:
            data = self.model.preprocess(split.get_data(cloud_id), attr)
        probs = test_probs[cloud_id]
        if "proj_inds" in data:
            probs = probs[data["proj_inds"]]
        results_per_cloud[cloud_id] = {"predict_labels": probs.argmax(-1),
                                       "predict_scores": probs}
        if save_results and not self.dataset.is_tested(attr):
            self.dataset.save_test_result(results_per_cloud[cloud_id], attr)
