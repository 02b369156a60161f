"""Dataset-split wrapper: preprocess -> transform.

Counterpart of ``open3d_ml_tpu/dataloaders/dataloader.py``
``PointCloudDataloader`` without the disk cache of preprocessed clouds
and the epoch length override, which come with the training slice: every
item runs ``preprocess`` anew.
"""


class PointCloudDataloader:
    """Wraps a dataset split with its model's data pipeline.

    Args:
        dataset: a ``BaseDatasetSplit``.
        preprocess: ``model.preprocess`` or None.
        transform: ``model.transform`` or None.
    """

    def __init__(self, dataset, preprocess=None, transform=None):
        self.dataset = dataset
        self.preprocess = preprocess
        self.transform = transform

    def __getitem__(self, index):
        """{'data': the transformed sample, 'attr': its attributes}."""
        dataset = self.dataset
        index = index % len(dataset)
        attr = dataset.get_attr(index)
        data = dataset.get_data(index)
        if self.preprocess is not None:
            data = self.preprocess(data, attr)
        if self.transform is not None:
            data = self.transform(data, attr)
        return {"data": data, "attr": attr}

    def __len__(self):
        return len(self.dataset)
