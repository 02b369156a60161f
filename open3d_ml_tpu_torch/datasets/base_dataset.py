"""Abstract dataset and dataset split.

Counterpart of ``open3d_ml_tpu/datasets/base_dataset.py``: a dataset holds
its configuration (``cfg``) and gives its splits; a split has a length,
gives each cloud (a dict of numpy arrays {'point', 'feat', 'label'}) and
its attributes, and owns the sampler that draws its patches (the test
split a ``SemSegSpatiallyRegularSampler``, the others the configured
``sampler``, by default a ``SemSegRandomSampler``). The samplers are
seeded from the dataset's generator, which ``seed`` seeds (the JAX
package's samplers are unseeded).
"""

from abc import ABC, abstractmethod

import numpy as np

from ..utils.config import ModuleConfig
from ..utils.registry import SAMPLER


class BaseDataset(ABC):
    """Base of the datasets; the keyword arguments become ``cfg``."""

    def __init__(self, **kwargs):
        if kwargs.get("dataset_path") is None:
            raise KeyError("Provide dataset_path to initialize the dataset")
        if kwargs.get("name") is None:
            raise KeyError("Provide dataset name to initialize it")
        self.cfg = ModuleConfig(kwargs)
        self.name = self.cfg.name
        self.rng = np.random.default_rng(kwargs.get("seed", None))

    @staticmethod
    @abstractmethod
    def get_label_to_names():
        """dict: label id -> name."""

    @abstractmethod
    def get_split(self, split):
        """The ``BaseDatasetSplit`` of 'training', 'validation', 'test' or
        'all'."""

    @abstractmethod
    def is_tested(self, attr):
        """True if a test result is stored for the cloud of ``attr``."""

    @abstractmethod
    def save_test_result(self, results, attr):
        """Store the prediction for the cloud of ``attr``."""


class BaseDatasetSplit(ABC):
    """Access to one split of a dataset; ``sampler`` draws its patches.

    Splits that wrap a dataset call ``__init__``; a split of its own (as
    ``InferenceDummySplit``) sets ``split`` and ``sampler`` itself.
    """

    def __init__(self, dataset, split="training"):
        self.cfg = dataset.cfg
        self.path_list = dataset.get_split_list(split)
        self.split = split
        self.dataset = dataset
        if split == "test":
            name = "SemSegSpatiallyRegularSampler"
        else:
            name = self.cfg.get("sampler",
                                {"name": "SemSegRandomSampler"})["name"]
        seed = (None if self.cfg.get("seed") is None else
                int(dataset.rng.integers(np.iinfo(np.int32).max)))
        self.sampler = SAMPLER.get(name)(self, seed=seed)

    @abstractmethod
    def __len__(self):
        """Number of clouds in the split."""

    @abstractmethod
    def get_data(self, idx):
        """The cloud: a dict of numpy arrays {'point', 'feat', 'label'}."""

    @abstractmethod
    def get_attr(self, idx):
        """The cloud's attributes: {'idx', 'name', 'path', 'split'}."""
