"""Abstract dataset split.

Counterpart of ``open3d_ml_tpu/datasets/base_dataset.py``
``BaseDatasetSplit``, as far as inference needs it: a split has a length,
gives each datum and its attributes, and owns a sampler. Dataset readers
and their split lists come with the training slice.
"""

from abc import ABC, abstractmethod


class BaseDatasetSplit(ABC):
    """Access to one split of a dataset; ``sampler`` draws its patches."""

    @abstractmethod
    def __len__(self):
        """Number of clouds in the split."""

    @abstractmethod
    def get_data(self, idx):
        """The cloud: a dict of numpy arrays {'point', 'feat', 'label'}."""

    @abstractmethod
    def get_attr(self, idx):
        """The cloud's attributes: {'idx', 'name', 'path', 'split'}."""
