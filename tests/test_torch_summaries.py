"""The port's logging helpers, label colours and TensorBoard summaries
against the JAX package's: ``utils/log.py`` (``LogRecord``, ``get_runid``,
``code2md``), ``vis/labellut.py`` and ``vis/colormap.py``,
``pipelines/summaries.py`` (each package's ``record_summary`` and
``add_boxes_summary`` into its own event file in ``tmp_path``, read back
with TensorBoard's ``EventAccumulator``), and the writers of both pipelines' ``run_train``:
the six scalars of the JAX ``save_logs`` (its tags taken from the JAX
method itself, run on stand-in metrics), the command line and the
configuration as text, the run ids, and the first batch's clouds where
the summary config records the train split.
"""

import logging
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator)
from torch.utils.tensorboard import SummaryWriter

from open3d_ml_tpu.modules.metrics import SemSegMetric as JaxSemSegMetric
from open3d_ml_tpu.pipelines.semantic_segmentation import (
    SemanticSegmentation as JaxSemanticSegmentation)
from open3d_ml_tpu.datasets.utils import BEVBox3D as JaxBEVBox3D
from open3d_ml_tpu.pipelines.summaries import (
    add_boxes_summary as jax_add_boxes)
from open3d_ml_tpu.pipelines.summaries import record_summary as jax_record
from open3d_ml_tpu.utils import log as jax_log
from open3d_ml_tpu.vis import Colormap as JaxColormap
from open3d_ml_tpu.vis import LabelLUT as JaxLabelLUT
from open3d_ml_tpu_torch.datasets import SyntheticBoxes, SyntheticShapes
from open3d_ml_tpu_torch.models import PointPillars, RandLANet
from open3d_ml_tpu_torch.pipelines import ObjectDetection, SemanticSegmentation
from open3d_ml_tpu_torch.datasets.utils import BEVBox3D
from open3d_ml_tpu_torch.pipelines.summaries import (add_boxes_summary,
                                                     record_summary)
from open3d_ml_tpu_torch.utils import LogRecord, code2md, get_runid
from open3d_ml_tpu_torch.vis import Colormap, LabelLUT

from test_torch_objdet import MODEL_CFG, PIPE
from test_torch_randlanet import SMALL
from torch_threads import one_torch_thread  # noqa: F401

TEXTS = {"Description/Command line/text_summary",
         "Configuration/text_summary"}


def _events(folder):
    """The ``EventAccumulator`` of the one run under ``folder``."""
    runs = sorted(Path(folder).iterdir())
    assert len(runs) == 1, runs
    acc = EventAccumulator(str(runs[0]))
    acc.Reload()
    return runs[0], acc


def test_get_runid_matches_jax(tmp_path):
    base = tmp_path / "train_log"
    assert get_runid(str(base / "RandLANet_S3DIS_torch")) == "00001"
    base.mkdir()
    for name in ("00003_RandLANet_S3DIS_torch", "00007_RandLANet_S3DIS_jax",
                 "x_RandLANet_S3DIS_torch", "00011_Other_torch", "loose",
                 "00002_RandLANet_S3DIS_torch"):
        (base / name).mkdir()
    for name in ("RandLANet_S3DIS_torch", "RandLANet_S3DIS_jax", "Fresh"):
        path = str(base / name)
        assert get_runid(path) == jax_log.get_runid(path), name
    assert get_runid(str(base / "RandLANet_S3DIS_torch")) == "00004"


def test_code2md_and_log_record_match_jax():
    text = "model:\n  name: RandLANet\n"
    for language in ("yaml", "python"):
        assert code2md(text, language) == jax_log.code2md(text, language)
    for msg, args in (("{} of {}", (3, 4)), ("{a}-{b}", ({"a": 1, "b": 2},)),
                      ("plain", ())):
        got = LogRecord("x", logging.INFO, "f", 1, msg, args, None)
        want = jax_log.LogRecord("x", logging.INFO, "f", 1, msg, args, None)
        assert got.getMessage() == want.getMessage()


def test_label_lut_and_colormap_match_jax():
    names = {k: f"class {k}" for k in (4, 0, 2, 9, 7)}
    names.update({k: f"more {k}" for k in range(10, 45)})
    got, want = LabelLUT(names), JaxLabelLUT(names)
    assert sorted(got.labels) == sorted(want.labels)
    for key in want.labels:
        assert got.labels[key].name == want.labels[key].name
        assert got.labels[key].color == want.labels[key].color
    for mode in (None, "lightbg", "darkbg"):
        assert LabelLUT.get_colors(mode=mode) == JaxLabelLUT.get_colors(
            mode=mode)
    values = np.random.default_rng(0).uniform(-2, 5, 100)
    for make in ("make_greyscale", "make_rainbow"):
        np.testing.assert_array_equal(
            getattr(Colormap, make)().calc_color_array(values, -1.0, 4.0),
            getattr(JaxColormap, make)().calc_color_array(values, -1.0, 4.0))


@pytest.mark.parametrize("record_for", [["train"], ["valid"]])
def test_record_summary_tags_match_jax(tmp_path, record_for):
    """Each package's ``record_summary`` into its own event file: the same
    mesh tags (vertices and colours of the first ``max_outputs`` clouds,
    cut to ``max_pts``), and the same vertex colours; nothing where the
    split is not recorded."""
    rng = np.random.default_rng(3)
    data = {"coords": rng.uniform(-5, 5, (3, 300, 3)).astype(np.float32)}
    results = rng.normal(0, 1, (3, 300, 6)).astype(np.float32)
    cfg = {"record_for": record_for, "max_outputs": 2, "max_pts": 200}
    names = {k: f"c{k}" for k in range(6)}
    tags, colors = [], []
    for sub, fn in (("port", record_summary), ("jax", jax_record)):
        writer = SummaryWriter(str(tmp_path / sub / "run"))
        fn(writer, cfg, "train", "semseg", data, results, 0, names)
        writer.close()
        _, acc = _events(tmp_path / sub)
        tags.append(acc.Tags()["tensors"])
        colors.append([acc.Tensors(t)[0].tensor_proto.SerializeToString()
                       for t in sorted(acc.Tags()["tensors"])])
    assert tags[0] == tags[1]
    assert colors[0] == colors[1]
    if record_for == ["train"]:
        assert len(tags[0]) == 4  # vertices and colours of two clouds
    else:
        assert tags[0] == []


def test_add_boxes_summary_matches_jax(tmp_path):
    """Each package's ``add_boxes_summary`` of the same boxes into its own
    event file: one mesh of 14 vertices a box under the tag, the same
    tensor bytes; no event for no boxes."""
    rng = np.random.default_rng(5)
    params = [(rng.uniform(-10, 10, 3), rng.uniform(0.5, 4, 3),
               float(rng.uniform(-3, 3)), label, conf)
              for label, conf in (("Car", -1.0), ("Pedestrian", 0.4),
                                  ("Car", 0.9))]
    protos = []
    for sub, fn, box in (("port", add_boxes_summary, BEVBox3D),
                         ("jax", jax_add_boxes, JaxBEVBox3D)):
        writer = SummaryWriter(str(tmp_path / sub / "run"))
        fn(writer, "boxes/gt", [box(*p) for p in params], step=3)
        fn(writer, "boxes/none", [], step=3)
        writer.close()
        _, acc = _events(tmp_path / sub)
        tags = sorted(acc.Tags()["tensors"])
        assert tags == ["boxes/gt_VERTEX"], tags
        event = acc.Tensors(tags[0])[0]
        assert event.step == 3
        shape = [d.size for d in event.tensor_proto.tensor_shape.dim]
        assert shape == [1, 14 * len(params), 3]
        protos.append(event.tensor_proto.SerializeToString())
    assert protos[0] == protos[1]


def _semseg(tmp_path, **pipeline):
    dataset = SyntheticShapes(
        num_points_per_cloud=1500, seed=0,
        num_clouds={"training": 2, "validation": 1, "test": 1},
        steps_per_epoch_train=2, steps_per_epoch_valid=2)
    model = RandLANet(seed=0, **dict(SMALL, num_points=512))
    return SemanticSegmentation(
        model, dataset=dataset, device="cpu", seed=0, max_epoch=0,
        batch_size=2, val_batch_size=2, num_workers=0,
        main_log_dir=str(tmp_path / "logs"),
        train_sum_dir=str(tmp_path / "tb"), **pipeline)


def _jax_scalar_tags(tmp_path):
    """The tags the JAX pipeline's ``save_logs`` writes, from the JAX
    method run on stand-in losses and metrics."""
    metric = JaxSemSegMetric()
    metric.update_cm(np.eye(3, dtype=np.int64))
    fake = types.SimpleNamespace(metric_train=metric, metric_val=metric,
                                 losses=[1.0], valid_losses=[2.0])
    writer = SummaryWriter(str(tmp_path / "jax_tags" / "run"))
    JaxSemanticSegmentation.save_logs(fake, writer, 0)
    writer.close()
    return set(_events(tmp_path / "jax_tags")[1].Tags()["scalars"])


def test_semseg_run_train_writes_jax_scalars_and_config(tmp_path):
    """``run_train``'s events: JAX's six scalar tags, one value each for
    the one epoch, the training loss the epoch's mean; the command line
    and the configuration (with the model's name) as text; the run
    directory ``<run id>_<model>_<dataset>_torch``, the next run's id one
    more."""
    pipe = _semseg(tmp_path)
    pipe.run_train()
    run, acc = _events(tmp_path / "tb")
    assert run.name == "00001_RandLANet_SyntheticShapes_torch"
    tags = acc.Tags()
    assert set(tags["scalars"]) == _jax_scalar_tags(tmp_path)
    assert len(tags["scalars"]) == 6
    loss = acc.Scalars("Training loss")
    assert [e.step for e in loss] == [0]
    assert loss[0].value == pytest.approx(np.mean(pipe.losses), rel=1e-6)
    assert TEXTS <= set(tags["tensors"])
    config = acc.Tensors("Configuration/text_summary")[0].tensor_proto
    text = config.string_val[0].decode()
    assert text.startswith("```yaml\n") and "name: SemanticSegmentation" in \
        text
    assert not [t for t in tags["tensors"] if t.startswith("semseg/")]
    assert pipe._make_writer() and Path(pipe.tensorboard_dir).name == \
        "00002_RandLANet_SyntheticShapes_torch"


def test_semseg_records_train_clouds_when_configured(tmp_path):
    """With ``summary.record_for: [train]`` the first training batch's
    clouds go to the mesh plugin once an epoch, coloured by the net's
    labels (``max_outputs`` clouds of at most ``max_pts`` points)."""
    pipe = _semseg(tmp_path, summary={"record_for": ["train"],
                                      "max_outputs": 2, "max_pts": 100})
    pipe.run_train()
    _, acc = _events(tmp_path / "tb")
    meshes = sorted(t for t in acc.Tags()["tensors"]
                    if t.startswith("semseg/train/"))
    assert len(meshes) == 4 and meshes[0].startswith("semseg/train/0")
    shape = acc.Tensors(meshes[0])[0].tensor_proto.tensor_shape
    assert [d.size for d in shape.dim] == [1, 100, 3]


def test_objdet_run_train_writes_losses_map_and_config(tmp_path):
    """``ObjectDetection.run_train``: each loss of the epoch as
    ``train/<loss>`` (the JAX pipeline's tags), the validation mAP as
    ``valid/mAP_BEV`` and ``valid/mAP_3D``, and the text."""
    ds = SyntheticBoxes(dataset_path=str(tmp_path), seed=0,
                        num_clouds={"training": 1, "validation": 1,
                                    "test": 1})
    pipe = ObjectDetection(PointPillars(**MODEL_CFG), dataset=ds,
                           device="cpu", batch_size=1, max_epoch=0,
                           main_log_dir=str(tmp_path / "logs"),
                           train_sum_dir=str(tmp_path / "tb"),
                           **dict(PIPE, difficulties=[0]))
    pipe.run_train()
    run, acc = _events(tmp_path / "tb")
    assert run.name == "00001_PointPillars_SyntheticBoxes_torch"
    tags = acc.Tags()
    assert set(tags["scalars"]) == (
        {f"train/{k}" for k in pipe.losses} |
        {"valid/mAP_BEV", "valid/mAP_3D"})
    for key, values in pipe.losses.items():
        got = acc.Scalars(f"train/{key}")[0].value
        assert got == pytest.approx(np.mean(values), rel=1e-6)
    assert acc.Scalars("valid/mAP_BEV")[0].value == pytest.approx(
        pipe.valid_map_bev, rel=1e-6)
    assert TEXTS <= set(tags["tensors"])


def test_summary_modules_import_no_jax():
    import subprocess
    import sys
    code = ("import sys\n"
            "import open3d_ml_tpu_torch.pipelines.summaries\n"
            "import open3d_ml_tpu_torch.utils.log\n"
            "import open3d_ml_tpu_torch.vis\n"
            "bad = [m for m in ('jax', 'flax', 'open3d_ml_tpu')\n"
            "       if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code],
                   cwd=Path(__file__).resolve().parents[1], check=True,
                   timeout=120)
    assert torch.utils.tensorboard  # the writer is torch's own
