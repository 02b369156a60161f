"""The port's configuration against the JAX package's: ``Config`` loading
of every shipped YAML, ``merge_cfg_file`` and ``merge_module_cfg_file``
under one set of command-line arguments and dotted extras, the port's
copies of the YAMLs it runs, ``get_module`` over the port's registries,
and the two kinds of dict (a file's ``ConfigDict``, where a missing key
reads as None, and a module's ``ModuleConfig``, where it raises)."""

import argparse
from pathlib import Path

import pytest
import yaml

from open3d_ml_tpu.utils import Config as JaxConfig
from open3d_ml_tpu.utils import config as jax_config
from open3d_ml_tpu_torch import DATASET, MODEL, PIPELINE, SAMPLER
from open3d_ml_tpu_torch.utils import (Config, ConfigDict, ModuleConfig,
                                       config, get_module)
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_CONFIGS = REPO / "open3d_ml_tpu" / "configs"
PORT_CONFIGS = REPO / "open3d_ml_tpu_torch" / "configs"
SHIPPED = sorted(JAX_CONFIGS.glob("*.yml"))
DEFAULTS = sorted((JAX_CONFIGS / "default_cfgs").glob("*.yml"))
# the YAMLs the port ships: each a copy of the JAX file of the same name
PORTED = ("randlanet_semantickitti", "sparseconvunet_scannet",
          "randlanet_s3dis", "randlanet_semantic3d", "randlanet_toronto3d",
          "randlanet_parislille3d", "pointtransformer_s3dis",
          "kpconv_semantickitti", "kpconv_s3dis", "kpconv_semantic3d",
          "kpconv_toronto3d", "kpconv_parislille3d", "pointrcnn_kitti",
          "pvcnn_s3dis", "pointpillars_kitti", "pointpillars_lyft",
          "pointpillars_nuscenes", "pointpillars_waymo",
          "pointpillars_argoverse")
# dotted extras as the command line gives them: coerced to bool, None,
# int and float, a nested key new to the file, and a string
EXTRAS = {"dataset.use_cache": "true", "model.ckpt_path": "none",
          "pipeline.batch_size": "3", "pipeline.optimizer.lr": "1e-3",
          "model.augment.new_step.nested.key": "12", "dataset.steps": "no",
          "pipeline.main_log_dir": "./somewhere"}


def _args(device, **kwargs):
    fields = dict(device=device, split="test", main_log_dir="/tmp/logs",
                  dataset_path="/data/root", ckpt_path=None, seed=7,
                  batch_size=None, max_epochs=0)
    fields.update(kwargs)
    return argparse.Namespace(**fields)


def _drop_device(sections):
    out = []
    for section in sections:
        d = section.to_dict()
        d.pop("device", None)
        out.append(d)
    return out


def test_every_yaml_is_counted():
    assert len(SHIPPED) == 20 and len(DEFAULTS) == 10


@pytest.mark.parametrize("path", SHIPPED + DEFAULTS,
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_load_from_file_equals_jax(path):
    got = Config.load_from_file(path)
    want = JaxConfig.load_from_file(path)
    assert got.to_dict() == want.to_dict()
    assert isinstance(got.cfg_dict, ConfigDict)
    assert list(got.keys()) == list(want.keys())


@pytest.mark.parametrize("path", SHIPPED, ids=lambda p: p.name)
def test_merge_cfg_file_equals_jax(path):
    """The same arguments and extras give the same three sections; only
    the device differs (the JAX command line's default is tpu, the
    port's cuda)."""
    got = Config.merge_cfg_file(Config.load_from_file(path),
                                _args("cuda"), dict(EXTRAS))
    want = JaxConfig.merge_cfg_file(JaxConfig.load_from_file(path),
                                    _args("tpu"), dict(EXTRAS))
    assert _drop_device(got) == _drop_device(want)
    dataset, model, pipeline = got
    assert pipeline.device == model.device == "cuda"
    assert dataset.use_cache is True and dataset.steps is False
    assert model.ckpt_path is None
    assert pipeline.batch_size == 3 and pipeline.seed == 7
    assert pipeline.optimizer.lr == 1e-3
    # a key under a dict new to the file keeps its string: the merge
    # coerces only values it sets itself, not a new dict's (JAX's too)
    assert model.augment.new_step.nested.key == "12"
    assert dataset.dataset_path == "/data/root"
    # --max_epochs 0 is falsy and dropped, as in the JAX package
    assert pipeline.max_epoch == want[2].max_epoch


@pytest.mark.parametrize("triple", [
    ("semantickitti", "randlanet", "semantic_segmentation"),
    ("s3dis", "kpconv", "semantic_segmentation"),
    ("toronto3d", "randlanet", "object_detection")])
def test_merge_module_cfg_file_equals_jax(triple):
    """--cfg_dataset/--cfg_model/--cfg_pipeline: three default_cfgs files,
    one a section, with the extras."""
    dataset, model, pipeline = (JAX_CONFIGS / "default_cfgs" / f"{name}.yml"
                                for name in triple)
    kw = dict(cfg_dataset=str(dataset), cfg_model=str(model),
              cfg_pipeline=str(pipeline))
    got = Config.merge_module_cfg_file(_args("cuda", **kw), dict(EXTRAS))
    want = JaxConfig.merge_module_cfg_file(_args("tpu", **kw), dict(EXTRAS))
    assert _drop_device(got) == _drop_device(want)
    assert got[1].name == yaml.safe_load(model.read_text())["name"]


@pytest.mark.parametrize("name", PORTED)
def test_port_yaml_equals_jax_twin(name):
    """The port's copy parses to the JAX file's values; its comments
    cite no figure of the JAX package's studies."""
    port = PORT_CONFIGS / f"{name}.yml"
    assert (yaml.safe_load(port.read_text()) ==
            yaml.safe_load((JAX_CONFIGS / f"{name}.yml").read_text()))
    text = port.read_text()
    for word in ("TPU", "ACCURACY_", "mIoU", "throughput"):
        assert word not in text


def test_port_ships_only_those_yamls():
    assert sorted(p.stem for p in PORT_CONFIGS.glob("*.yml")) == sorted(
        PORTED)


def test_load_py_config_equals_jax(tmp_path):
    path = tmp_path / "cfg_py_case.py"
    path.write_text("dataset = {'name': 'Custom3D', 'x': [1, 2]}\n"
                    "model = {'name': 'RandLANet'}\n_private = 3\n")
    assert (Config.load_from_file(path).to_dict() ==
            JaxConfig.load_from_file(path).to_dict())


def test_load_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        Config.load_from_file(tmp_path / "missing.yml")
    (tmp_path / "cfg.txt").write_text("dataset: {}\n")
    with pytest.raises(IOError):
        Config.load_from_file(tmp_path / "cfg.txt")


@pytest.mark.parametrize("value", ["true", "Yes", "FALSE", "no", "None",
                                   "null", "3", "-4", "1e-3", "0.5", "inf",
                                   "abc", "[1, 2]", "", "0x10"])
def test_coerce_equals_jax(value):
    got, want = config._coerce(value), jax_config._coerce(value)
    assert got == want and type(got) is type(want)


def test_config_dict_semantics():
    """A file's ConfigDict: attributes, recursion through dicts in lists,
    a missing key reads as None; ``Config.get`` gives the default for a
    None value, as the JAX package's does."""
    d = ConfigDict({"a": {"b": [{"c": 1}]}, "n": None})
    assert d.a.b[0].c == 1 and d.missing is None
    d.x = {"y": 2}
    assert d.x.y == 2 and isinstance(d.x, ConfigDict)
    assert d.to_dict() == {"a": {"b": [{"c": 1}]}, "n": None,
                           "x": {"y": 2}}
    cfg, jcfg = Config(d.to_dict()), JaxConfig(d.to_dict())
    assert cfg.get("n", 5) == jcfg.get("n", 5) == 5
    assert cfg.nothing is None and jcfg.nothing is None
    with pytest.raises(TypeError):
        Config([1])


def test_module_config_raises_on_a_missing_key():
    """A module's cfg keeps the port's semantics: a missing key raises
    (the JAX modules' cfg reads it as None)."""
    model = get_module("model", "RandLANet")(num_points=256)
    assert isinstance(model.cfg, ModuleConfig)
    assert model.cfg.num_points == 256
    with pytest.raises(AttributeError):
        model.cfg.not_a_key
    assert model.cfg.get("not_a_key") is None


@pytest.mark.parametrize("kind,registry", [
    ("model", MODEL), ("dataset", DATASET), ("pipeline", PIPELINE),
    ("sampler", SAMPLER)])
def test_get_module_finds_every_registered_name(kind, registry):
    assert registry.keys()
    for name in registry.keys():
        assert get_module(kind, name) is registry.get(name)
    with pytest.raises(KeyError) as err:
        get_module(kind, "NotRegistered")
    assert str(registry.keys()) in str(err.value)


def test_get_module_refuses_an_unknown_kind_and_no_name():
    with pytest.raises(KeyError):
        get_module("backbone", "RandLANet")
    with pytest.raises(ValueError):
        get_module("model", None)


def test_shipped_readers_and_models_are_registered():
    """Every dataset and model the port's YAMLs name is registered."""
    for name in PORTED:
        cfg = Config.load_from_file(PORT_CONFIGS / f"{name}.yml")
        assert get_module("dataset", cfg.dataset.name)
        assert get_module("model", cfg.model.name)
        assert get_module("pipeline", cfg.pipeline.name)
