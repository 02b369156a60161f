"""Single-datum pseudo split used by ``run_inference``.

Counterpart of ``open3d_ml_tpu/datasets/inference_dummy.py``: wraps one
in-memory cloud as a test split, so the normal dataloader machinery
applies. ``seed`` seeds its sampler (None: unseeded, as in the JAX
package).
"""

from ..utils.registry import SAMPLER
from .base_dataset import BaseDatasetSplit


class InferenceDummySplit(BaseDatasetSplit):

    def __init__(self, inference_data, seed=None):
        self.split = "test"
        self.inference_data = inference_data
        self.sampler = SAMPLER.get("SemSegSpatiallyRegularSampler")(
            self, seed=seed)

    def __len__(self):
        return 1

    def get_data(self, idx):
        return self.inference_data

    def get_attr(self, idx):
        return {"idx": 0, "name": "inference", "path": "", "split": "test"}
