"""The port's PointRCNN through ``ObjectDetection`` and the command line
(``open3d_ml_tpu_torch``) against the JAX pipeline, on the CPU, on
KITTI-format frames written into a temporary directory by
``chip_smoke.write_kitti_frame``.

The frames are sparse lidar scenes: many points have near-equal RPN
scores, 1e-7 apart, so the order of the proposals is a matter of
rounding and the two packages' nets may pick different rois
(``test_torch_pointrcnn.py`` holds the nets by replay). The pipelines
are therefore compared with the JAX net replayed as the port
pipeline's eval net (``JaxReplay``): the transform's draws, the batch,
the decode, the refinement NMS and the boxes in the lidar frame must
then equal the JAX pipeline's (boxes within ``TOL``: XLA fuses the
decode; mAP within 1e-9). The port's own net runs every entry point to
the end beside it.
"""

from pathlib import Path

import numpy as np
import pytest
import torch


import chip_smoke
from open3d_ml_tpu.datasets import KITTI as JaxKITTI
from open3d_ml_tpu.models import PointRCNN as JaxPointRCNN
from open3d_ml_tpu.pipelines import ObjectDetection as JaxObjectDetection
from open3d_ml_tpu.pipelines.semantic_segmentation import TrainState
from open3d_ml_tpu_torch import MODEL, run_pipeline
from open3d_ml_tpu_torch.datasets import KITTI
from open3d_ml_tpu_torch.models import PointRCNN
from open3d_ml_tpu_torch.pipelines import ObjectDetection
from open3d_ml_tpu_torch.utils.convert_jax import (net_layout,
                                                  state_dict_to_jax)

from test_torch_pointrcnn import SMALL, _boxes_close, _np

REPO = Path(__file__).resolve().parents[1]
PRCNN_YML = REPO / "open3d_ml_tpu_torch/configs/pointrcnn_kitti.yml"


PIPE = dict(val_batch_size=1, test_batch_size=1, num_workers=0,
            overlaps=[0.1], difficulties=[0, 1, 2],
            similar_classes={"Van": "Car"})
# the pipelines' model: SMALL's widths at 4,096 points a frame, fewer
# than the frames hold (~10,000), so that no point repeats: repeated
# points give coincident proposals, whose IoU JAX's fused arithmetic
# gets wrong (``test_torch_nms.py`` ``test_coincident_box_iou_fault``)
PIPE_MODEL = dict(SMALL, mode="RCNN", npoints=4096, ckpt_path=None)


class JaxReplay(torch.nn.Module):
    """The JAX pipeline's net as a port pipeline's eval net: the JAX
    pipeline's own jitted function (``infer``) on the batch's arrays and
    the JAX state, its outputs as tensors; it keeps the JAX variables
    whatever ``load_state_dict`` is given."""

    def __init__(self, infer, state):
        super().__init__()
        self.infer, self.state = infer, state

    def load_state_dict(self, state_dict, strict=True, assign=False):
        return None

    def forward(self, inputs):
        out = self.infer(self.state.params, self.state.batch_stats,
                         {k: _np(v) for k, v in inputs.items()})
        return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Frames 0-3 of 'training' (val_split 2: two of them validation) and
    0-1 of 'testing', written by ``chip_smoke.write_kitti_frame``."""
    root = tmp_path_factory.mktemp("kitti")
    for i in range(4):
        chip_smoke.write_kitti_frame(root, "training", i, 30 + i)
    for i in range(2):
        chip_smoke.write_kitti_frame(root, "testing", i, 40 + i)
    return root


@pytest.fixture(scope="module")
def pipelines(kitti_root, tmp_path_factory):
    """A port ObjectDetection with PointRCNN on the KITTI frames and its
    seeded weights, a JAX one with the same weights, and a second port
    pipeline whose eval net replays the JAX pipeline's net."""
    logs = tmp_path_factory.mktemp("logs")
    out = {}
    for name in ("port", "replay"):
        ds = KITTI(dataset_path=str(kitti_root), val_split=2,
                   test_result_folder=str(logs / f"{name}_test"))
        out[name] = ObjectDetection(PointRCNN(**PIPE_MODEL), dataset=ds,
                                    device="cpu",
                                    main_log_dir=str(logs / name), **PIPE)
    # the port pipeline's seeded weights, as JAX variables (the converter's
    # round trip: test_torch_pointrcnn.py)
    net = out["port"].net
    v = state_dict_to_jax(net.state_dict(), **net_layout(net))
    out["replay"].net.load_state_dict(net.state_dict())
    jmodel = JaxPointRCNN(**PIPE_MODEL)
    jds = JaxKITTI(dataset_path=str(kitti_root), val_split=2,
                   test_result_folder=str(logs / "jax_test"))
    jpipe = JaxObjectDetection(jmodel, dataset=jds,
                               main_log_dir=str(logs / "jax"), **PIPE)
    jpipe.state = TrainState(params=v["params"],
                             batch_stats=v["batch_stats"], opt_state=None,
                             step=0)
    # one jitted function for every entry point: the pipeline makes a new
    # one a call, and each would compile the net again
    infer = jpipe._make_infer_fn()
    jpipe._make_infer_fn = lambda: infer
    out["jax"] = jpipe
    out["replay"].eval_net = JaxReplay(infer, jpipe.state)
    return out


def test_transform_draws_equal_jax(kitti_root):
    """preprocess and transform of every split bit-equal to JAX's from the
    same seed: the test split's draw of 4,096 of a frame's points, the
    validation split's near/far draw and its padded camera-frame gt
    boxes."""
    port, ref = PointRCNN(**PIPE_MODEL), JaxPointRCNN(**PIPE_MODEL)
    for split in ("test", "validation"):
        p = KITTI(dataset_path=str(kitti_root), val_split=2).get_split(split)
        r = JaxKITTI(dataset_path=str(kitti_root), val_split=2).get_split(
            split)
        for i in range(len(p)):
            attr = p.get_attr(i)
            got = port.transform(port.preprocess(p.get_data(i), attr), attr)
            want = ref.transform(ref.preprocess(r.get_data(i), attr), attr)
            assert set(got) == set(want)
            for key in ("point", "bboxes", "bbox_count", "labels"):
                if key in want:
                    np.testing.assert_array_equal(got[key], want[key])
            assert got["point"].shape == (4096, 3)


def test_pipeline_run_inference(pipelines, kitti_root):
    """The port's run_inference on a KITTI frame: with the JAX net
    replayed, the JAX pipeline's boxes (transform, collate, decode,
    refinement NMS, camera to lidar); with its own net, boxes from RPN
    outputs within ``TOL`` of JAX's (the proposals' order on this sparse
    frame is a matter of rounding: ``test_rcnn_replay_on_jax_rpn``)."""
    data = KITTI(dataset_path=str(kitti_root)).get_split("test").get_data(1)
    want = pipelines["jax"].run_inference(data)
    got = pipelines["replay"].run_inference(data)
    assert len(want) > 0
    _boxes_close(got, want)
    own = pipelines["port"].run_inference(data)
    assert len(own) > 0 and all(np.isfinite(b.to_xyzwhlr()).all()
                                for b in own)


def test_pipeline_run_valid_and_test(pipelines):
    """run_valid: the same mAP BEV and 3D; run_test: the same boxes, one
    KITTI result file a frame; the JAX net replayed in the port's
    pipeline (the port's own net runs both from the command line,
    ``test_cli_serves_the_shipped_yaml``)."""
    jpipe, pipe = pipelines["jax"], pipelines["replay"]
    got = pipe.run_valid()
    want = jpipe.run_valid()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-9)
    got = pipe.run_test()
    want = jpipe.run_test()
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _boxes_close(g, w)
    files = sorted(Path(pipe.dataset.cfg.test_result_folder).glob("*.txt"))
    assert [f.name for f in files] == ["000000.txt", "000001.txt"]


def test_run_train_and_losses_raise(tmp_path, kitti_root):
    """Training is not ported: run_train, get_loss and get_optimizer raise
    NotImplementedError naming the ROADMAP item; so does the RCNN net in
    train mode and mode RPN's labelled splits."""
    model = PointRCNN(**PIPE_MODEL)
    pipe = ObjectDetection(model, dataset=KITTI(
        dataset_path=str(kitti_root), val_split=2), device="cpu",
        main_log_dir=str(tmp_path), **PIPE)
    for call in (pipe.run_train, lambda: model.get_loss({}, {}),
                 lambda: model.get_optimizer(pipe.cfg, pipe.net),
                 lambda: pipe.net.train()({"point": torch.zeros(1, 64, 3)})):
        with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
            call()
    rpn = PointRCNN(**dict(PIPE_MODEL, mode="RPN"))
    data = {"point": np.zeros((100, 3), np.float32), "calib": None}
    with pytest.raises(NotImplementedError, match="queue 1 item 6b"):
        rpn.transform(data, {"split": "validation"})
    with pytest.raises(ValueError, match="mode"):
        PointRCNN(mode="rcnn")
    assert MODEL.get("PointRCNN") is PointRCNN


def _cli_argv(tmp_path, root, split):
    return ["-c", str(PRCNN_YML), "--device", "cpu",
            "--dataset.dataset_path", str(root),
            "--dataset.test_result_folder", str(tmp_path / "test"),
            "--dataset.val_split", "2",
            "--main_log_dir", str(tmp_path / "logs"),
            "--pipeline.num_workers", "0", "--model.mode", "RCNN",
            "--model.npoints", "4096", "--model.rpn.head.nms_pre", "512",
            "--model.rcnn.target_head.num_points", "128",
            "--split", split]


@pytest.mark.parametrize("split", ["test", "valid"])
def test_cli_serves_the_shipped_yaml(split, kitti_root, tmp_path,
                                     monkeypatch):
    """``python -m open3d_ml_tpu_torch.run_pipeline -c
    open3d_ml_tpu_torch/configs/pointrcnn_kitti.yml --model.mode RCNN``
    at the shipped widths (4,096 points, 512 candidates and 128 points a
    roi to stay quick on the CPU): ``--split test`` writes one KITTI result file a
    frame (with boxes: the override took, the YAML says ``mode: RPN``),
    ``--split valid`` gives a finite mAP."""
    seen = {}
    real = ObjectDetection.run_valid

    def run_valid(self, epoch=0):
        seen["valid"] = real(self, epoch)
        return seen["valid"]

    monkeypatch.setattr(ObjectDetection, "run_valid", run_valid)
    run_pipeline.main(_cli_argv(tmp_path, kitti_root, split))
    if split == "test":
        files = sorted((tmp_path / "test").glob("*.txt"))
        assert [f.name for f in files] == ["000000.txt", "000001.txt"]
        assert any(f.read_text().strip() for f in files)
    else:
        assert all(np.isfinite(a).all() for a in seen["valid"])
