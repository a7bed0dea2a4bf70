"""The bridge to the program under test, ``resnet_tpu_torch``: its
configuration for a cell, the preset with what the configuration file
states set on it, and its process-wide settings. The reference never imports this
module.
"""

from __future__ import annotations

import dataclasses


def _section_field(cfg, dotted: str):
    """(section, field) of a dotted program field such as ``train.lr``;
    a name that is not a field of the program's ``Config`` is refused."""
    section_name, _, name = dotted.partition(".")
    section = getattr(cfg, section_name, None)
    if not dataclasses.is_dataclass(section) or name not in {
            f.name for f in dataclasses.fields(section)}:
        raise KeyError(f"{dotted!r} is not a field of the program's Config")
    return section, name


def _as_field(old, value):
    """A JSON value in the type the preset holds it in: lists become
    tuples where the preset has a tuple."""
    if isinstance(old, tuple) and isinstance(value, list):
        return tuple(_as_field(None, v) for v in value)
    return value


def stated(config: dict) -> dict:
    """Dotted program fields -> the values the configuration file states
    for them."""
    m, t, d = config["model"], config["train"], config["data"]
    out = {"model.depth": m["depth"], "model.bn_eps": m["bn_eps"],
           "model.bn_mom": m["bn_mom"], "model.group_width": m["group_width"],
           "data.num_classes": m["num_classes"],
           "train.bn_ema_clamp": m["bn_ema_clamp"],
           "model.network": "resnext" if m["cardinality"] > 1 else "resnet"}
    if m["cardinality"] > 1:
        out["model.cardinality"] = m["cardinality"]
    for k in ("batch_size", "steps_per_dispatch", "lr", "mom", "wd", "dtype",
              "bn_ema", "stem_s2d", "aug_s2d", "grouped_dense",
              "grouped_merge", "label_smooth"):
        out["train." + k] = t[k]
    out["train.bn_ema_project"] = t["radial_projection"]
    for k, v in d.items():
        out["data." + k] = v
    out.update(config["program"])
    return out


def cell_config(config: dict, traffic: dict, seed: int):
    """The program's ``Config`` for a cell: the preset the configuration
    names, with every value the file states set on it (each must be a
    field of the program's ``Config``); then the run's seed, no
    checkpoint prefix, the traffic's batch where it sets one, and the
    images at the configuration's size. Returns the config and the
    fields where the file departs from the preset, as (preset, file)."""
    from resnet_tpu_torch.config import PRESETS
    cfg = PRESETS[config["preset"]]()
    departs = {}
    for dotted, value in stated(config).items():
        section, name = _section_field(cfg, dotted)
        old = getattr(section, name)
        value = _as_field(old, value)
        if value != old:
            departs[dotted] = (old, value)
            setattr(section, name, value)
    side = config["model"]["image"]
    cfg.data.image_shape = (side, side, 3)
    cfg.train.seed = seed
    cfg.train.model_prefix = ""
    if traffic.get("batch"):
        cfg.train.batch_size = traffic["batch"]
    return cfg, departs


def backend_defaults(device_type: str) -> None:
    """The port's default backend switches (``--xla-opts`` unset), as its
    entry point sets them once for the process."""
    from resnet_tpu_torch.utils.xla_opts import (apply_backend_options,
                                                 compiler_options)
    apply_backend_options(compiler_options(None, device_type))


def enable_cache(path: str) -> None:
    from resnet_tpu_torch.utils.cache import enable_compile_cache
    enable_compile_cache(path)
