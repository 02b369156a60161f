"""Lyft Level 5 3D object detection dataset reader (info pickles).

Counterpart of ``open3d_ml_tpu/datasets/lyft.py``: the nuScenes info
format (``infos_{train,val,test}.pkl``, [N, 5] sweeps, the boxes with
lidar points in them), read by the nuScenes reader's code, with Lyft's
9 classes.
"""

from ..utils import DATASET
from .nuscenes import NuScenes


@DATASET.register_module()
class Lyft(NuScenes):
    """Lyft Level 5: 9 detection classes, in nuScenes' info format."""

    NUM_CLASSES = 9

    def __init__(self,
                 dataset_path,
                 info_path=None,
                 name="Lyft",
                 cache_dir="./logs/cache",
                 use_cache=False,
                 test_result_folder="./test",
                 **kwargs):
        super().__init__(dataset_path=dataset_path,
                         info_path=info_path,
                         name=name,
                         cache_dir=cache_dir,
                         use_cache=use_cache,
                         test_result_folder=test_result_folder,
                         **kwargs)

    @staticmethod
    def get_label_to_names():
        return {
            0: "ignore", 1: "bicycle", 2: "bus", 3: "car",
            4: "emergency_vehicle", 5: "motorcycle", 6: "other_vehicle",
            7: "pedestrian", 8: "truck", 9: "animal"
        }
