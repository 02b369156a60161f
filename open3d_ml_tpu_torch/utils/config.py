"""A model's configuration: a dict whose keys also read as attributes.

The part of ``open3d_ml_tpu/utils/config.py`` that a model needs. Loading
YAML files and merging command-line overrides belong to the pipelines,
which are not ported yet.
"""


class Config(dict):
    """``cfg.seg`` reads ``cfg["seg"]``; a missing key raises."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def to_dict(self):
        return dict(self)
