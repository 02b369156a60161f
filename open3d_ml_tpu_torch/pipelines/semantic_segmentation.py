"""Semantic segmentation pipeline: inference.

Counterpart of ``open3d_ml_tpu/pipelines/semantic_segmentation.py``
``run_inference``, ``run_test_on_split`` and ``_maybe_finalize_cloud``:
the possibility-map patch loop, which draws patches until every point of
the cloud is covered, blends each patch's class probabilities into the
cloud's accumulator and projects them onto the input points.

The network is the model's eval net (``get_eval_net``), built once on
``device`` in eval mode; its ``state_dict`` is the pipeline's state. It
starts from weights drawn from a generator seeded by the pipeline's
``seed``; load trained ones with ``net.load_state_dict`` (for JAX
variables, ``utils.convert_jax.jax_to_state_dict``). Training, testing over
dataset splits and checkpoints come with the training slice.
"""

import numpy as np
import torch

from ..dataloaders import DefaultBatcher, PointCloudDataloader
from ..datasets import InferenceDummySplit
from ..utils.registry import PIPELINE
from .base_pipeline import BasePipeline


def init_weights(net, gen):
    """Draw ``net``'s weights from ``gen`` as torch's defaults do: a
    Linear's weight and bias uniform in +-1/sqrt(fan_in), BatchNorm at the
    identity."""
    with torch.no_grad():
        for module in net.modules():
            if isinstance(module, torch.nn.Linear):
                bound = module.in_features ** -0.5
                module.weight.uniform_(-bound, bound, generator=gen)
                module.bias.uniform_(-bound, bound, generator=gen)
            elif isinstance(module, torch.nn.BatchNorm1d):
                module.reset_parameters()
    return net


@PIPELINE.register_module()
class SemanticSegmentation(BasePipeline):
    """Patch-wise inference for point cloud semantic segmentation."""

    def __init__(self, model, dataset=None, name="SemanticSegmentation",
                 test_batch_size=1, device="cuda", **kwargs):
        super().__init__(model=model, dataset=dataset, name=name,
                         test_batch_size=test_batch_size, device=device,
                         **kwargs)
        gen = torch.Generator().manual_seed(
            int(self.rng.integers(np.iinfo(np.int32).max)))
        self.net = init_weights(model.get_eval_net(), gen)
        self.net.to(self.device).eval()

    def _device_batch(self, batch):
        """The batch's arrays as tensors on the pipeline's device."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in batch["data"].items()
                if isinstance(v, np.ndarray)}

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

    def run_test_on_split(self, test_split, test_sampler):
        """Possibility-map patch loop over every cloud of ``test_split``;
        returns {cloud id: result}."""
        model = self.model
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
                results = self.net(self._device_batch(batch)).cpu().numpy()

            for cid in set(cloud_ids):
                if cid not in test_probs:
                    n = test_sampler.possibilities[cid].shape[0]
                    test_probs[cid] = np.zeros((n, model.cfg.num_classes),
                                               np.float16)
            for j, cid in enumerate(cloud_ids):
                test_probs[cid] = model.update_probs(
                    {k: v[j:j + 1] for k, v in batch["data"].items()},
                    results[j:j + 1], test_probs[cid])
            for cid in set(cloud_ids) - set(results_per_cloud):
                self._maybe_finalize_cloud(cid, test_split, test_sampler,
                                           test_probs, results_per_cloud)
        return results_per_cloud

    def _maybe_finalize_cloud(self, cloud_id, test_split, test_sampler,
                              test_probs, results_per_cloud):
        """When a cloud is covered, project its probabilities onto the
        input points and store the prediction."""
        if test_sampler.min_possibilities[cloud_id] <= 0.5:
            return
        dataset = test_split.dataset
        data = self.model.preprocess(dataset.get_data(cloud_id),
                                     dataset.get_attr(cloud_id))
        probs = test_probs[cloud_id]
        if "proj_inds" in data:
            probs = probs[data["proj_inds"]]
        results_per_cloud[cloud_id] = {"predict_labels": probs.argmax(-1),
                                       "predict_scores": probs}
