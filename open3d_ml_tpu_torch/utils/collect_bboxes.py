"""Write the gt-box database of ``ObjectSample`` augmentation.

Counterpart of ``scripts/collect_bboxes.py``: every frame of a dataset's
training split gives its gt boxes, each with the points inside it
(``points_inside_box``), and the boxes of all frames are pickled as one
list. A database names the class of its boxes, so this one loads with the
port alone (``ObjdetAugmentation.load_gt_database``); one the JAX script
wrote imports the JAX package.

    python -m open3d_ml_tpu_torch.utils.collect_bboxes \\
        --dataset_path path/to/kitti [--out_path dir] [--max_pc N]

writes ``<out_path>/bboxes.pkl`` (``out_path`` defaults to the dataset's
path); point ``ObjectSample.pickle_path`` of the model's ``augment``
section at it.
"""

import argparse
import pickle
from os.path import join

import numpy as np

from ..datasets.utils.operations import points_in_box


def frame_boxes(split, idx):
    """The gt boxes of frame ``idx`` of ``split``, each holding the points
    inside it."""
    data = split.get_data(idx)
    boxes = data["bounding_boxes"]
    inside = points_in_box(data["point"], [box.to_xyzwhlr() for box in boxes])
    for j, box in enumerate(boxes):
        box.points_inside_box = data["point"][inside[:, j]]
    return boxes


def collect(dataset, out_file, max_pc=None):
    """Pickle the boxes of the training split of ``dataset`` (of
    ``max_pc`` frames drawn at random when given) to ``out_file``;
    returns the number of boxes."""
    train = dataset.get_split("train")
    indices = list(range(len(train)))
    if max_pc is not None and max_pc < len(indices):
        indices = list(np.random.default_rng().choice(indices, max_pc,
                                                      replace=False))
    boxes = []
    for n, i in enumerate(indices):
        boxes.extend(frame_boxes(train, int(i)))
        if (n + 1) % 100 == 0:
            print(f"processed {n + 1}/{len(indices)} frames, "
                  f"{len(boxes)} boxes")
    with open(out_file, "wb") as f:
        pickle.dump(boxes, f)
    return len(boxes)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Collect the gt boxes of a training split for "
        "ObjectSample augmentation.")
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--out_path", default=None)
    parser.add_argument("--dataset_type", default="KITTI")
    parser.add_argument("--max_pc", type=int, default=None)
    args = parser.parse_args(argv)

    from .. import datasets  # noqa: F401  (registers the readers)
    from .registry import DATASET
    dataset = DATASET.get(args.dataset_type)(args.dataset_path)
    out_file = join(args.out_path or args.dataset_path, "bboxes.pkl")
    count = collect(dataset, out_file, args.max_pc)
    print(f"Saved {count} boxes to {out_file}")
    return out_file


if __name__ == "__main__":
    main()
