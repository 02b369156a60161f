"""Dataset-split wrapper: preprocess (with its disk cache) -> transform.

Counterpart of ``open3d_ml_tpu/dataloaders/dataloader.py``
``PointCloudDataloader``. With ``use_cache`` every cloud's preprocess
output is written to a disk cache (under the dataset's ``cache_dir``) when
the loader is made and read back from there; ``steps_per_epoch`` overrides
the length, so an epoch may visit the clouds more or fewer times. The cache
is off by default here (the JAX class defaults it on), since a split of
one in-memory cloud, as ``run_inference`` makes, has no cache directory.
"""

from ..utils import Cache, get_hash


class PointCloudDataloader:
    """Wraps a dataset split with its model's data pipeline.

    Args:
        dataset: a ``BaseDatasetSplit``.
        preprocess: ``model.preprocess`` or None.
        transform: ``model.transform`` or None.
        sampler: the split's sampler.
        use_cache: cache the preprocess outputs on disk.
        steps_per_epoch: the length, when given.
    """

    def __init__(self, dataset, preprocess=None, transform=None, sampler=None,
                 use_cache=False, steps_per_epoch=None):
        self.dataset = dataset
        self.preprocess = preprocess
        self.transform = transform
        self.sampler = sampler
        self.steps_per_epoch = steps_per_epoch
        self.cache_convert = None
        if preprocess is not None and use_cache:
            cache_dir = dataset.cfg.get("cache_dir", "./logs/cache")
            self.cache_convert = Cache(preprocess, cache_dir=cache_dir,
                                       cache_key=get_hash(repr(preprocess)))
            for idx in range(len(dataset)):
                attr = dataset.get_attr(idx)
                if attr["name"] not in self.cache_convert.cached_ids:
                    # written to the cache as a side effect
                    self.cache_convert(attr["name"], dataset.get_data(idx),
                                       attr)

    def __getitem__(self, index):
        """{'data': the transformed sample, 'attr': its attributes}."""
        dataset = self.dataset
        index = index % len(dataset)
        attr = dataset.get_attr(index)
        if self.cache_convert is not None:
            data = self.cache_convert(attr["name"])
        elif self.preprocess is not None:
            data = self.preprocess(dataset.get_data(index), attr)
        else:
            data = dataset.get_data(index)
        if self.transform is not None:
            data = self.transform(data, attr)
        return {"data": data, "attr": attr}

    def __len__(self):
        if self.steps_per_epoch is not None:
            return self.steps_per_epoch
        return len(self.dataset)
