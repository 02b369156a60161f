"""Configuration: config files, attribute-access dicts and command-line
overrides.

Counterpart of ``open3d_ml_tpu/utils/config.py``, with the same file-level
API: ``Config.load_from_file`` (.yml, .yaml, .py), ``merge_cfg_file``
(known command-line arguments, then dotted ``--section.key value`` extras
coerced to bool, None, int or float) and ``merge_module_cfg_file`` (three
files, one a section). A ``Config`` holds a tree of ``ConfigDict``: a
dict whose keys also read as attributes, where a missing key reads as
None, as in the JAX package.

The configuration of a model, a dataset or a pipeline (its ``cfg``, made
from its keyword arguments) is a ``ModuleConfig``: flat, and a missing
key raises ``AttributeError``; the modules read optional keys with
``get``. (The JAX modules' ``cfg`` is a ``Config``, where a missing key
reads as None.)

PyYAML is imported only to read or write a YAML file.
"""

import copy
import importlib.util
import sys
from pathlib import Path


class ModuleConfig(dict):
    """A module's configuration: ``cfg.seg`` reads ``cfg["seg"]``; a
    missing key raises."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def to_dict(self):
        return dict(self)


class ConfigDict(dict):
    """A dict with attribute access, applied recursively to nested dicts
    (in lists and tuples too); a missing attribute reads as None."""

    def __init__(self, *args, **kwargs):
        super().__init__()
        for arg in args:
            if arg is None:
                continue
            if not isinstance(arg, dict):
                raise TypeError(f"ConfigDict takes dicts, got {type(arg)}")
            for k, v in arg.items():
                self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            return None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setitem__(self, key, value):
        super().__setitem__(key, self._wrap(value))

    def __deepcopy__(self, memo):
        out = ConfigDict()
        for k, v in self.items():
            out[copy.deepcopy(k, memo)] = copy.deepcopy(v, memo)
        return out

    def to_dict(self):
        """The tree as plain dicts (lists and tuples kept)."""
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigDict):
                v = v.to_dict()
            elif isinstance(v, (list, tuple)):
                v = type(v)(x.to_dict() if isinstance(x, ConfigDict) else x
                            for x in v)
            out[k] = v
        return out


def _coerce(value):
    """A command-line string as bool, None, int or float where it reads as
    one, else unchanged."""
    if not isinstance(value, str):
        return value
    low = value.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("none", "null"):
        return None
    try:
        return int(value)
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    return value


def _merge_into(base, extra, coerce=False):
    """Merge dict ``extra`` into dict ``base`` in place, dict into dict;
    returns ``base``."""
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge_into(base[k], v, coerce=coerce)
        else:
            base[k] = _coerce(v) if coerce else v
    return base


class Config:
    """A configuration tree with the sections dataset, model and
    pipeline."""

    def __init__(self, cfg_dict=None):
        if cfg_dict is None:
            cfg_dict = {}
        if not isinstance(cfg_dict, dict):
            raise TypeError(f"cfg_dict must be a dict, got {type(cfg_dict)}")
        self._cfg_dict = ConfigDict(cfg_dict)

    @property
    def cfg_dict(self):
        return self._cfg_dict

    def __getattr__(self, name):
        # only reached when normal lookup fails
        return getattr(self._cfg_dict, name)

    def __getitem__(self, name):
        return self._cfg_dict[name]

    def __contains__(self, name):
        return name in self._cfg_dict

    def get(self, key, default=None):
        v = self._cfg_dict.get(key, default)
        return default if v is None else v

    def items(self):
        return self._cfg_dict.items()

    def keys(self):
        return self._cfg_dict.keys()

    def to_dict(self):
        return self._cfg_dict.to_dict()

    def dump(self):
        import yaml
        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    @staticmethod
    def load_from_file(filename):
        """The ``Config`` of a .yml, .yaml or .py file (a .py file's
        top-level names not starting with ``__``)."""
        path = Path(filename)
        if not path.exists():
            raise FileNotFoundError(f"Config file not found: {filename}")
        if path.suffix in (".yml", ".yaml"):
            import yaml
            with open(path) as f:
                cfg = yaml.safe_load(f)
        elif path.suffix == ".py":
            spec = importlib.util.spec_from_file_location(path.stem, str(path))
            mod = importlib.util.module_from_spec(spec)
            sys.modules[path.stem] = mod
            spec.loader.exec_module(mod)
            cfg = {
                k: v for k, v in vars(mod).items() if not k.startswith("__")
            }
        else:
            raise IOError(f"Unsupported config format: {path.suffix}")
        return Config(cfg or {})

    @staticmethod
    def merge_cfg_file(cfg, args=None, extra_dict=None):
        """Merge the known command-line arguments and the dotted extras
        into a loaded ``Config``.

        ``args`` is a namespace whose attributes device, split,
        main_log_dir, dataset_path, ckpt_path, seed, batch_size and
        max_epochs override their keys where set (a falsy value but a seed
        of 0 is not set); ``extra_dict`` maps dotted keys such as
        ``dataset.use_cache`` to strings. Returns the ``ConfigDict``s
        (dataset, model, pipeline).
        """
        d = cfg.to_dict()
        d.setdefault("dataset", {})
        d.setdefault("model", {})
        d.setdefault("pipeline", {})
        if args is not None:
            if getattr(args, "device", None):
                d["pipeline"]["device"] = args.device
                d["model"]["device"] = args.device
            if getattr(args, "split", None):
                d["pipeline"]["split"] = args.split
            if getattr(args, "main_log_dir", None):
                d["pipeline"]["main_log_dir"] = args.main_log_dir
            if getattr(args, "dataset_path", None):
                d["dataset"]["dataset_path"] = args.dataset_path
            if getattr(args, "ckpt_path", None):
                d["model"]["ckpt_path"] = args.ckpt_path
            if getattr(args, "seed", None) is not None:
                d["pipeline"]["seed"] = args.seed
            if getattr(args, "batch_size", None):
                d["pipeline"]["batch_size"] = args.batch_size
            if getattr(args, "max_epochs", None):
                d["pipeline"]["max_epoch"] = args.max_epochs
        if extra_dict:
            nested = {}
            for dotted, value in extra_dict.items():
                node = nested
                parts = dotted.split(".")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = value
            _merge_into(d, nested, coerce=True)
        merged = Config(d)
        return (merged.cfg_dict.dataset, merged.cfg_dict.model,
                merged.cfg_dict.pipeline)

    @staticmethod
    def merge_module_cfg_file(args=None, extra_dict=None):
        """``merge_cfg_file`` over the three files ``args.cfg_dataset``,
        ``args.cfg_model`` and ``args.cfg_pipeline``, one a section."""
        cfg_dataset = Config.load_from_file(args.cfg_dataset).to_dict()
        cfg_model = Config.load_from_file(args.cfg_model).to_dict()
        cfg_pipeline = Config.load_from_file(args.cfg_pipeline).to_dict()
        cfg = Config({
            "dataset": cfg_dataset,
            "model": cfg_model,
            "pipeline": cfg_pipeline,
        })
        return Config.merge_cfg_file(cfg, args, extra_dict)
